"""hand_kernel_ms_per_call: self device time a call of the program's own
CUDA and Triton kernels, found by name in its sources (layer: kernels)."""

from portbench.metrics._by_class import ms_per_call


def read(run):
    return ms_per_call(run, "hand")
