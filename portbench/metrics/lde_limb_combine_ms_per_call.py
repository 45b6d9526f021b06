"""lde_limb_combine_ms_per_call: device ms a call of the
``gf.limb_matmul.combine`` spans: the diagonals' int64 cast and column
scatter, the limb carries and the fold and Barrett reduction (layer: limb
matmul)."""

from portbench.metrics._by_window import device_ms_per_call


def read(run):
    return device_ms_per_call(run, "gf.limb_matmul.combine")
