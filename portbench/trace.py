"""The traced run: torch.profiler over the window, read into intervals.

The harness marks each traced call with a ``portbench.call`` span and its
own work between calls with ``portbench.repeat_check``. The traced window
runs from the first traced call's start to the last call's end. A device operation
(kernel, copy or fill) belongs to the program when the host launched it
inside a call span, found through the launch's correlation id; the
harness's own kernels between calls are left out of every per-layer sum.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch

__all__ = ["CALL_SPAN", "CHECK_SPAN", "Tracer", "Digest", "span"]

CALL_SPAN = "portbench.call"
CHECK_SPAN = "portbench.repeat_check"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def span(name: str, on: bool):
    """A profiler span around the block, or nothing when not tracing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _activity(ev, name: str) -> str:
    """The event's kineto activity type. Where the event does not give it
    (torch before 2.12), it is told from the device and the name: on the
    device "Memcpy ..." and "Memset ..." are copies and fills, the harness's
    own span names are annotations, the rest kernels; on the host "cu..."
    names are CUDA runtime or driver calls, the harness's spans annotations,
    the rest operators."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind() if callable(kind) else kind)
    on_device = ev.device_type() != torch.autograd.DeviceType.CPU
    if name.startswith("portbench."):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


class Digest:
    """What the per-layer metrics read from one traced window.

    ``ops``: the program's device operations (activity, name, start_ns,
    end_ns) inside the window; ``busy_ns``: the union of every device
    operation's interval there, the harness's included; ``window_ns``;
    ``calls``: the number of call spans; ``gaps``: the idle stretches of
    the device (start_ns, end_ns, host op that spanned them)."""

    def __init__(self, events):
        calls, device, host, launch_at = [], [], [], {}
        for ev in events:
            name = ev.name()
            kind = _activity(ev, name)
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if kind in DEVICE_OPS:
                device.append((kind, name, start, end, ev.correlation_id()))
            elif kind in HOST_OPS:
                host.append((start, end, name))
                if kind in ("cuda_runtime", "cuda_driver"):
                    launch_at[ev.correlation_id()] = start
                elif name == CALL_SPAN:
                    calls.append((start, end))
        calls.sort()
        self.calls = len(calls)
        if not calls:
            self.window_ns, self.busy_ns, self.ops, self.gaps = 0, 0, [], []
            return
        w0, w1 = calls[0][0], calls[-1][1]
        self.window_ns = w1 - w0
        starts = [c[0] for c in calls]

        def in_call(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= calls[i][1]

        self.ops, spans = [], []
        for kind, name, start, end, corr in device:
            s, e = max(start, w0), min(end, w1)
            if e <= s:
                continue
            spans.append((s, e))
            if in_call(launch_at.get(corr, start)):
                self.ops.append((kind, name, s, e))
        spans.sort()
        busy, merged = 0, []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        self.busy_ns = busy
        idle, t = [], w0
        for s, e in merged:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if t < w1:
            idle.append((t, w1))
        self.gaps = [(s, e, name) for (s, e), name in zip(idle, _innermost(host, [(s + e) // 2 for s, e in idle]))]

    def device_ops(self, top: int = 10):
        """The program's device operations that took most time: [[name, s]]."""
        total = collections.Counter()
        for _, name, s, e in self.ops:
            total[name] += (e - s) / 1e9
        return [[n, v] for n, v in total.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """The device's idle time by the host op that spanned it: [[name, s]]."""
        total = collections.Counter()
        for s, e, name in self.gaps:
            total[name] += (e - s) / 1e9
        return [[n, v] for n, v in total.most_common(top)]


def _innermost(host, times):
    """For each time (in any order), the name of the innermost host span
    that holds it, or "no host op". Spans on one thread nest, so a stack
    swept in time order holds the innermost on top."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(host, key=lambda h: (h[0], -h[1]))
    names, stack, j = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names[i] = stack[-1][2] if stack else "no host op"
    return names


class Tracer:
    """torch.profiler with CPU and CUDA activities, started before the window
    and collecting over its last ``TRACED_SECONDS`` (all of a shorter one).
    Starting the profiler takes seconds, so it starts paused in set-up; and
    its post-processing grows with the events, about 2000 kernels and several
    thousand host operators a decode: a whole 20-s window took a traced run
    past four minutes."""

    TRACED_SECONDS = 5.0

    def __init__(self, seconds: float):
        from torch.profiler import ProfilerActivity, profile

        self.start_at = max(0.0, seconds - self.TRACED_SECONDS)
        self._activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self._prof = profile(activities=self._activities)
        self._prof.start()
        self._prof.toggle_collection_dynamic(False, self._activities)

    def start(self):
        self._prof.toggle_collection_dynamic(True, self._activities)

    def stop(self):
        self._prof.stop()

    def digest(self) -> Digest:
        return Digest(self._prof.profiler.kineto_results.events())
