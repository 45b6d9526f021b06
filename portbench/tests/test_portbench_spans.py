"""The per-layer metrics that read the program's spans: on synthetic records
and a synthetic digest (CPU), against a program without spans, and on a
CUDA card, where a traced run of each cell reports them and no device
operation bears a span's name."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench import trace as tr
from portbench.metrics import _by_span

ROOT = harness.ROOT
SPEC = harness.load_spec()
SPAN_METRICS = {  # metric: the span it reads (None: the host's issue time)
    "syndromes_ms_per_call": "gf.decode.syndromes",
    "erasure_locator_ms_per_call": "gf.decode.erasure_locator",
    "berlekamp_massey_ms_per_call": "gf.decode.berlekamp_massey",
    "chien_ms_per_call": "gf.decode.chien",
    "forney_ms_per_call": "gf.decode.forney",
    "bitplane_ms_per_call": "gf.binary_matmul",
    "host_issue_ms_per_call": None,
}
NEW = [*SPAN_METRICS, "python_gap_ms_per_call"]


# a call: (name, position of its parent in the call, host start and end ms, device ms)
CALL = [("gf.decode", None, 0, 60, 58.0), ("gf.decode.syndromes", 0, 1, 2, 3.0), ("gf.binary_matmul", 1, 1, 2, 2.5),
        ("gf.decode.erasure_locator", 0, 2, 3, 4.0), ("gf.binary_matmul", 3, 2, 3, 1.0),
        ("gf.decode.berlekamp_massey", 0, 3, 4, 1.0), ("gf.decode.chien", 0, 4, 9, 19.0),
        ("gf.binary_matmul", 6, 4, 9, 18.0), ("gf.decode.forney", 0, 9, 20, 30.0), ("gf.binary_matmul", 8, 9, 14, 12.0),
        ("gf.binary_matmul", 8, 14, 19, 12.0), ("gf.decode.readback", 0, 20, 59, 0.5)]


def _rec(index, name, call, parent, start_ms, end_ms, device_ms):
    return SimpleNamespace(index=index, name=name, call=call, parent=parent, start_ns=round(start_ms * 1e6),
                           end_ns=round(end_ms * 1e6), device_ms=device_ms)


def _records():
    """Two calls as ``CALL``, the second 100 ms later and with its readback
    1 ms sooner after its start."""
    first = [_rec(i, n, 0, p, s, e, d) for i, (n, p, s, e, d) in enumerate(CALL)]
    base = len(CALL)
    second = [_rec(base + i, n, base, None if p is None else base + p, 100 + s - (n == "gf.decode.readback"),
                   100 + e, d) for i, (n, p, s, e, d) in enumerate(CALL)]
    return first + second


def test_device_ms_per_call_divides_by_the_decodes():
    recs = _records()
    assert _by_span.device_ms_per_call(recs, "gf.decode.chien") == 19.0
    assert _by_span.device_ms_per_call(recs, "gf.binary_matmul") == 2.5 + 1 + 18 + 12 + 12
    one_locator = [r for r in recs if not (r.name == "gf.decode.erasure_locator" and r.call)]
    assert _by_span.device_ms_per_call(one_locator, "gf.decode.erasure_locator") == 2.0  # over both calls
    assert _by_span.device_ms_per_call([r for r in recs if r.name != "gf.decode"], "gf.decode.chien") is None
    no_device = [_rec(r.index, r.name, r.call, r.parent, 0, 1, None) for r in recs]
    assert _by_span.device_ms_per_call(no_device, "gf.decode.chien") is None


def test_host_issue_ms_runs_from_the_decode_to_its_readback():
    recs = _records()
    assert _by_span.host_issue_ms(recs) == pytest.approx((20 + 19) / 2)
    assert _by_span.host_issue_ms([r for r in recs if r.name != "gf.decode.readback"]) is None


def test_readers_read_the_records(monkeypatch):
    recs = _records()
    monkeypatch.setattr(_by_span, "records", lambda: recs)
    for metric, name in SPAN_METRICS.items():
        got = harness.load_reader("metrics", metric).read(None)
        want = _by_span.host_issue_ms(recs) if name is None else _by_span.device_ms_per_call(recs, name)
        assert got == want and got > 0, metric


def test_a_program_without_spans_gives_no_metric(monkeypatch):
    monkeypatch.setattr(_by_span, "PACKAGE", "no_such_program")
    assert _by_span.records() == []
    for metric in SPAN_METRICS:
        assert harness.load_reader("metrics", metric).read(None) is None


def _digest(gaps, calls=2, busy_ns=10**8):
    return SimpleNamespace(gaps=gaps, calls=calls, busy_ns=busy_ns)


def test_python_gap_counts_the_gaps_under_the_programs_spans():
    read = harness.load_reader("metrics", "python_gap_ms_per_call").read
    gaps = [(0, 2_000_000, "gf.decode.chien"), (5_000_000, 5_500_000, "gf.decode"), (6_000_000, 9_000_000, "aten::mm"),
            (10_000_000, 14_000_000, "portbench.call"), (15_000_000, 15_100_000, "gf.binary_matmul")]
    assert read(SimpleNamespace(digest=_digest(gaps))) == pytest.approx((2 + 0.5 + 0.1) / 2)
    parent = [g for g in gaps if not g[2].startswith("gf.")]  # a program without spans
    assert read(SimpleNamespace(digest=_digest(parent))) is None
    assert read(SimpleNamespace(digest=_digest(gaps, busy_ns=0))) is None  # nothing ran on a device
    assert read(SimpleNamespace(digest=_digest(gaps, calls=0))) is None


def test_every_new_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        assert set(entries[name]["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
        assert entries[name]["source"] in ("program_span", "device_trace")


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_traced_cell_reports_the_span_metrics(card, workload):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 22),
                        "--seconds", "2", "--trace", "1"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    want = {m["name"] for m in harness.metric_entries(SPEC, "per_layer", workload) if m["name"] in NEW}
    assert want <= set(r["metrics"]), sorted(want - set(r["metrics"]))
    assert not [n for n, _ in r["breakdown"]["device_ops"] if n.startswith("gf.")]


@pytest.mark.card
def test_no_device_operation_bears_a_span_name(card):
    """Traced as the harness traces a call: the spans are host ops, the
    device's operations keep their own names, and every span that times a
    device tensor carries device time."""
    import galois_tpu_torch as gt

    code = gt.ReedSolomon(255, 223, field=gt.GF(2**8))
    gen = torch.Generator(device=card).manual_seed(22)
    word = code.encode(code.field.Random((8192, code.k), generator=gen, device=card))
    code.decode(word)
    torch.cuda.synchronize()
    tracer = tr.Tracer(0.0)
    tracer.start()
    for _ in range(2):
        with tr.span(tr.CALL_SPAN, True):
            code.decode(word)
            torch.cuda.synchronize()
    tracer.stop()
    events = tracer._prof.profiler.kineto_results.events()
    ours = [ev for ev in events if ev.name().startswith("gf.")]
    assert ours and all(tr._activity(ev, ev.name()) in tr.HOST_OPS for ev in ours)
    assert all(ev.device_type() == torch.autograd.DeviceType.CPU for ev in ours)
    digest = tr.Digest(events)
    assert digest.calls == 2 and digest.ops and not [n for _, n, _, _ in digest.ops if n.startswith("gf.")]
    recs = _by_span.records()
    assert len([r for r in recs if r.name == "gf.decode"]) == 2 and all(r.device_ms > 0 for r in recs)
