"""lde_twiddle_ms_per_call: device ms a call of the ``gf.ntt.twiddle``
spans: the 4-step's twiddle product and the inverse's 1/N scale, kernel K10
(layer: NTT plan)."""

from portbench.metrics._by_window import device_ms_per_call


def read(run):
    return device_ms_per_call(run, "gf.ntt.twiddle")
