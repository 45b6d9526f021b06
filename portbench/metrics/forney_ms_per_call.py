"""forney_ms_per_call: device ms a call of the ``gf.decode.forney`` spans:
Omega', the derivative, Forney's two products and the correction (layer:
decoder stages)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.decode.forney")
