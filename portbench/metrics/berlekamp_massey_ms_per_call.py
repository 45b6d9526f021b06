"""berlekamp_massey_ms_per_call: device ms a call of the
``gf.decode.berlekamp_massey`` spans: the scan (K8-B) and, with erasures,
Lambda_total (layer: decoder stages)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.decode.berlekamp_massey")
