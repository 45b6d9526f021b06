"""bitplane_ms_per_call: device ms a call of every ``gf.binary_matmul`` span,
the bit-plane products' GEMMs and their passes together, in every stage
(layer: bit-plane products)."""

from portbench.metrics._by_span import device_ms_per_call, records


def read(run):
    return device_ms_per_call(records(), "gf.binary_matmul")
