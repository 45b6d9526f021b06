"""chien_ms_per_call: device ms a call of the ``gf.decode.chien`` spans:
Chien's product over the code's positions and the root masks (layer: decoder
stages)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.decode.chien")
