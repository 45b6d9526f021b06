"""The program's spans of one name, summed over every call of the window.

The traced run holds the profiler from the window's start, so the spans
(``galois_tpu_torch/_tracing.py``, read through ``_by_span.records``) cover
every call of the window, and a metric here divides by those calls
(``run.window_calls``), not by spans of its own kind. A program without the
spans, or a run that recorded none of the name, gives nothing."""

from portbench.metrics import _by_span


def device_ms_per_call(run, name: str):
    """Device ms of every span named ``name`` over the window's calls."""
    ms = [s.device_ms for s in _by_span.records() if s.name == name and s.device_ms is not None]
    if not run.window_calls or not ms:
        return None
    return sum(ms) / run.window_calls
