"""gemm_ms_per_call: self device time of library GEMM kernels a call, the
bit-plane products of ops/_binary_matmul.py (layer: bit-plane products)."""

from portbench.metrics._by_class import ms_per_call


def read(run):
    return ms_per_call(run, "gemm")
