"""The program's own spans (``galois_tpu_torch/_tracing.py``), read after the
window has closed and synchronised. A call is one ``gf.decode`` span; each
metric divides by its own count of calls. The spans cover every call of the
traced run's window, as the profiler is held from the window's start. A
program without the module, or a run that recorded no span, gives nothing."""

import importlib

from portbench.kernels import PACKAGE

DECODE = "gf.decode"
READBACK = "gf.decode.readback"


def records() -> list:
    """The program's finished spans, or [] where it has no span module."""
    try:
        tracing = importlib.import_module(f"{PACKAGE}._tracing")
    except ImportError:
        return []
    return tracing.spans()


def device_ms_per_call(recs, name: str):
    """Device ms of every span named ``name`` over the ``gf.decode`` spans."""
    calls = sum(1 for s in recs if s.name == DECODE)
    ms = [s.device_ms for s in recs if s.name == name and s.device_ms is not None]
    if not calls or not ms:
        return None
    return sum(ms) / calls


def host_issue_ms(recs):
    """Host ms from a ``gf.decode`` span's start to the start of its
    ``gf.decode.readback``, over the calls that have both."""
    start = {s.index: s.start_ns for s in recs if s.name == DECODE}
    ms = [(s.start_ns - start[s.call]) / 1e6 for s in recs if s.name == READBACK and s.call in start]
    if not ms:
        return None
    return sum(ms) / len(ms)
