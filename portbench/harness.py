"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration file it names, ``mixes/<traffic>.json``, the kind module
``kinds/<kind>.py`` that the configuration names, ``end_to_end/<metric>.py``
and ``metrics/<metric>.py`` for each metric. The window is a closed loop
with one caller: a call is issued when the previous one has returned and
synchronised, and the calls take the ring's batches in turn.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench import trace as tr
from portbench.kernels import PACKAGE as PROGRAM

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "galois_tpu")  # top-level module names, compared whole
LIMITS = {"msg_rows_wrong": 0, "count_rows_wrong": 0, "rows_unrepeated": 0}  # exact comparisons


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, workload: str, root: pathlib.Path = ROOT):
    """The cell's entry, its configuration file and its mix."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    return cell, config, mix


def metric_entries(spec: dict, section: str, workload: str) -> list:
    return [m for m in spec[section] if "workloads" not in m or workload in m["workloads"]]


def load_reader(folder: str, name: str):
    """``portbench/<folder>/<name>.py`` (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the harness must not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def launch_counters() -> dict:
    """The program's kernel-wrapper counters (``<wrapper>.launches``)."""
    out, seen = {}, set()
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != PROGRAM:
            continue
        for attr, fn in list(vars(mod).items()):
            count = getattr(fn, "launches", None) if callable(fn) else None
            if isinstance(count, int) and id(fn) not in seen:
                seen.add(id(fn))
                out[f"{getattr(fn, '__module__', mod_name)}.{attr}"] = count
    return out


@dataclass
class Window:
    latencies_s: list
    calls: int
    items: int
    window_s: float
    setup_s: float
    first: list  # per ring slot: the first call's (messages, counts)
    unrepeated: list  # per call: rows unlike the first call on its slot
    counters: dict = field(default_factory=dict)


def repeat_rows(out, cnt, first) -> tuple:
    """Rows of a call unlike the first call on the same batch: a device
    count of message rows and a host count of error counts."""
    return (out != first[0]).any(dim=1).sum(), int((cnt != first[1]).sum())


def measure(cell, ring, seconds: float, t_process: float, tracer=None) -> Window:
    """The window: calls in a closed loop for ``seconds`` (and at least once
    on every batch of the ring); ``tracer`` profiles its last seconds."""
    R = len(ring)
    before = launch_counters()
    lat, first, rep_dev, rep_host = [], [None] * R, [], []
    tracing = False
    cell.sync()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    i = 0
    while True:
        s = i % R
        if tracer is not None and not tracing and time.perf_counter() - t_start >= tracer.start_at:
            tracer.start()
            tracing = True
        with tr.span(tr.CALL_SPAN, tracing):
            t0 = time.perf_counter()
            out, cnt = cell.call(ring[s])
            cell.sync()
            t1 = time.perf_counter()
        lat.append(t1 - t0)
        with tr.span(tr.CHECK_SPAN, tracing):
            if first[s] is None:
                first[s] = (out, cnt)
            else:
                dev, host = repeat_rows(out, cnt, first[s])
                rep_dev.append((i, dev))
                rep_host.append((i, host))
        i += 1
        if i >= R and t1 - t_start >= seconds:
            break
    cell.sync()
    t_end = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    after = launch_counters()
    unrepeated = [0] * i
    if rep_dev:
        rows = torch.stack([d for _, d in rep_dev]).tolist()
        for (j, _), r in zip(rep_dev, rows):
            unrepeated[j] += r
    for j, h in rep_host:
        unrepeated[j] += h
    counters = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    return Window(lat, i, i * cell.items_per_call, t_end - t_start, setup_s, first, unrepeated, counters)


def check(cell, ring, w: Window) -> tuple:
    """The numbers compared, each with its limit, and the calls that gave a
    wrong answer."""
    msg_bad = cnt_bad = 0
    bad_slot = []
    for slot, (out, cnt) in zip(ring, w.first):
        m, c, rows = cell.wrong_rows(slot, out, cnt)
        msg_bad, cnt_bad = msg_bad + m, cnt_bad + c
        bad_slot.append(rows > 0)
    R = len(ring)
    failed = sum(1 for i in range(w.calls) if bad_slot[i % R] or w.unrepeated[i] > 0)
    values = {"msg_rows_wrong": msg_bad, "count_rows_wrong": cnt_bad, "rows_unrepeated": sum(w.unrepeated)}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}, failed


@dataclass
class TraceRun:
    """What a per-layer metric reads."""

    digest: object
    config: dict
    mix: dict
    window_calls: int  # every call of the window, traced or not
    counters: dict  # the wrappers' launches over those calls
    device_name: str
    root: pathlib.Path


def kind_module(config: dict):
    return importlib.import_module(f"portbench.kinds.{config['kind']}")


def run(workload: str, seed: int, seconds: float, trace: bool, device, t_process: float,
        spec: dict = None, mix_override: dict = None, control: str = None) -> dict:
    """One run of one cell on ``device``; returns the result line's object
    (its ``check`` key last)."""
    spec = spec or load_spec()
    _, config, mix = cell_parts(spec, workload)
    mix = {**mix, **(mix_override or {})}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stages = [("imports", time.perf_counter())]
    cell = kind_module(config).Cell(config, mix, dev, control=control)
    stages.append(("system", time.perf_counter()))
    ring = cell.make_ring(seed)
    cell.sync()
    stages.append(("inputs", time.perf_counter()))
    # warm-up: this cell's one shape, and the repeat check's ops
    warm = [cell.call(ring[s]) for s in range(min(2, len(ring)))]
    repeat_rows(*warm[0], warm[0])
    cell.sync()
    del warm
    stages.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(f"{name} {t - prev:.3f} s" for (name, t), prev in
                                 zip(stages, [t_process] + [t for _, t in stages[:-1]])), file=sys.stderr, flush=True)

    tracer = tr.Tracer(seconds) if trace else None
    w = measure(cell, ring, seconds, t_process, tracer)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if trace:
        t0 = time.perf_counter()
        digest = tracer.digest()
        print(f"trace: {w.calls} calls read in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        device_info["busy_s"] = digest.busy_ns / 1e9
        device_info["window_s"] = digest.window_ns / 1e9
        tr_run = TraceRun(digest, config, mix, w.calls, w.counters, name, ROOT)
        for m in metric_entries(spec, "per_layer", workload):
            value = load_reader("metrics", m["name"]).read(tr_run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": digest.device_ops(), "idle_gaps": digest.idle_gaps()}
    else:
        for m in metric_entries(spec, "end_to_end", workload):
            metrics[m["name"]] = {"value": load_reader("end_to_end", m["name"]).read(w), "unit": m["unit"]}

    checks, failed = check(cell, ring, w)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": w.calls, "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = checks
    return result
