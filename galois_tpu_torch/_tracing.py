"""Spans at the layer boundaries of the decode path, on while a torch profiler runs.

``span(name, like)`` marks a block of the program. It does something only
while ``torch.profiler`` runs, paused or collecting: there is no other
switch. Then the span

1. enters a ``RecordFunctionFast`` of its name, so that the block lands in
   the profiler's trace as a host op, on the same clock as the device's
   operations (``torch.profiler.record_function`` would also give it a
   device-side annotation, which a reader of the trace would count as a
   kernel);
2. keeps a record (name, ``call``, ``parent``, host start and end in
   ``time.time_ns()``, device ms) in a list of the last ``CAPACITY`` spans;
3. where ``like`` is a CUDA tensor, records a timing event on its device's
   current stream at entry and at exit. The time between the two is the
   span's stretch of that stream: its work and any wait for the host. It is
   resolved when the records are read, never inside the span.

With no profiler running a span costs one C call and a branch and returns a
shared no-op context. It is inert, too, while ``like``'s stream is capturing
a CUDA graph.

``call`` is the index of the outermost span around a record (its own where
it is outermost), ``parent`` the index of the span that encloses it (None
where there is none); spans nest per thread. Every name starts with
``gf.``: a reader of the trace takes names that start with ``cu``,
``Memcpy`` or ``Memset`` for CUDA runtime calls and device copies.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["CAPACITY", "Span", "span", "spans", "clear"]

CAPACITY = 2**17

_profiling = torch._C._autograd._profiler_enabled
_Fast = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """One finished span. ``device_ms`` is None where the span had no CUDA
    tensor to time."""

    index: int
    name: str
    call: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


_OFF = contextlib.nullcontext()
_records = collections.deque(maxlen=CAPACITY)
_index = itertools.count()
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _On:
    __slots__ = ("index", "name", "call", "parent", "start_ns", "end_ns", "device_ms", "_fast", "_stream", "_events")

    def __init__(self, name: str, like):
        self.name = name
        self.end_ns = self.device_ms = self._events = None
        self._stream = torch.cuda.current_stream(like.device) if like is not None and like.is_cuda else None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.index = next(_index)
        self.parent = stack[-1].index if stack else None
        self.call = stack[0].index if stack else self.index
        self._fast = _Fast(self.name)
        self._fast.__enter__()
        self.start_ns = time.time_ns()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        stack.append(self)
        _records.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        self.end_ns = time.time_ns()
        _open.stack.pop()
        self._fast.__exit__(*exc)
        return False


def span(name: str, like: torch.Tensor = None):
    """A span named ``name`` around the block, about ``like``'s device and
    stream; a shared no-op context when no profiler runs."""
    if not _profiling():
        return _OFF
    if like is not None and like.is_cuda and torch.cuda.is_current_stream_capturing():
        return _OFF
    return _On(name, like)


def spans() -> list:
    """The finished spans kept, oldest first, as ``Span`` records. Their
    device ms are resolved here, each waiting for its exit event: read them
    after the work is done."""
    out = []
    for s in list(_records):
        if s.end_ns is None:
            continue
        if s._events is not None:
            start, end = s._events
            end.synchronize()
            s.device_ms, s._events = start.elapsed_time(end), None
        out.append(Span(s.index, s.name, s.call, s.parent, s.start_ns, s.end_ns, s.device_ms))
    return out


def clear() -> None:
    """Forget every span kept."""
    _records.clear()
