"""torch_pass_ms_per_call: self device time a call of every kernel that is
neither a library GEMM nor one of the program's own (layer: torch passes)."""

from portbench.metrics._by_class import ms_per_call


def read(run):
    return ms_per_call(run, "torch")
