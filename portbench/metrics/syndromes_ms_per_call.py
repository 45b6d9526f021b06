"""syndromes_ms_per_call: device ms a call of the ``gf.decode.syndromes``
spans: the syndromes' product (B, n) @ W with the flip and cast before it
(layer: decoder stages)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.decode.syndromes")
