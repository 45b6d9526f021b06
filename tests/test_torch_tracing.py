"""The torch port's spans (``galois_tpu_torch/_tracing.py``) on the CPU.

With no profiler running a span records nothing. Under ``torch.profiler``
a decode records ``gf.decode`` and its stages, in order, nested on the host
clock, with the same names in the profiler's own events as host ops (not
user annotations); a GF(2^m) matmul records ``gf.binary_matmul``; the
results do not change; and the record keeps the last ``CAPACITY`` spans.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import galois_tpu_torch as gt
from galois_tpu_torch import _tracing

CODES = {"rs255": lambda: gt.ReedSolomon(255, 223), "bch511": lambda: gt.BCH(511, 493)}
STAGES = ["gf.decode.syndromes", "gf.decode.berlekamp_massey", "gf.decode.chien", "gf.decode.forney",
          "gf.decode.readback"]
ERASURE_STAGES = STAGES[:1] + ["gf.decode.erasure_locator"] + STAGES[1:]
CASES = [("rs255", False), ("rs255", True), ("bch511", False)]


@pytest.fixture(autouse=True)
def _on_cpu():
    """New data goes to CUDA by default; these tests run on the CPU, each
    with an empty record."""
    _tracing.clear()
    with gt.default_device("cpu"):
        yield
    _tracing.clear()


_inputs = {}


def _words(name, erasures: bool, rows: int = 6):
    """The code and a (rows, n) batch with min(i, t + 1) errors in row i, and
    two erasures a row where asked; made once, outside any profiler."""
    if (name, erasures) not in _inputs:
        with gt.default_device("cpu"):
            code = CODES[name]()
        rng = np.random.default_rng(22)
        q = code.field.order
        msg = rng.integers(0, q, (rows, code.k))
        cw = np.asarray(code.encode(code.field.from_numpy(msg, device="cpu"))).astype(np.int64)
        for i in range(rows):
            pos = rng.choice(code.n, size=min(i, code.t + 1), replace=False)
            cw[i, pos] = (cw[i, pos] + rng.integers(1, q, pos.size)) % q
        era = None
        if erasures:
            era = np.zeros(cw.shape, dtype=bool)
            era[:, [3, 40]] = True
        _inputs[name, erasures] = code, code.field.from_numpy(cw, device="cpu"), era
    return _inputs[name, erasures]


def _decode(words):
    code, word, era = words
    out, n_errors = code.decode(word, erasures=era, errors=True)
    return np.asarray(out), n_errors


@pytest.mark.parametrize("name", sorted(CODES))
def test_no_profiler_no_spans(name):
    _decode(_words(name, False))
    assert _tracing.spans() == []
    assert _tracing.span("gf.a") is _tracing.span("gf.b", like=torch.zeros(2))  # one shared no-op context


@pytest.mark.parametrize(["name", "erasures"], CASES)
def test_decode_records_its_stages_in_order(name, erasures):
    words = _words(name, erasures)
    with profile(activities=[ProfilerActivity.CPU]):
        _decode(words)
    recs = _tracing.spans()
    top = [s for s in recs if s.parent is None]
    assert [s.name for s in top] == ["gf.decode"]
    call = top[0]
    assert all(s.call == call.index for s in recs)
    children = [s for s in recs if s.parent == call.index]
    assert [s.name for s in children] == (ERASURE_STAGES if erasures else STAGES)
    by_index = {s.index: s for s in recs}
    for s in recs:
        assert s.start_ns <= s.end_ns and s.device_ms is None  # no CUDA tensor to time
        if s.parent is not None:
            p = by_index[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    products = [by_index[s.parent].name for s in recs if s.name == "gf.binary_matmul"]
    want = ["gf.decode.syndromes"] + ["gf.decode.erasure_locator"] * erasures + ["gf.decode.chien"] + [
        "gf.decode.forney"] * 2
    assert products == want


# torch operators that make no new values: views and casts to the same dtype
NO_WORK = {"aten::slice", "aten::as_strided", "aten::view", "aten::to", "aten::reshape", "aten::select",
           "aten::detach", "detach", "aten::resolve_conj", "aten::resolve_neg", "aten::alias"}


@pytest.mark.parametrize("erasures", [False, True])
def test_rs_decode_computes_only_inside_its_stages(erasures):
    """Every torch operator that computes something in an RS(255,223) decode
    runs inside one of the decode's stage spans (on the profiler's clock):
    the stages hold all of the decode's work, so their device times add up
    to the decode's busy time on a card. The erasures are a tensor on the
    codeword's device here; a NumPy mask is copied there before the stages."""
    code, word, era = _words("rs255", erasures)
    words = code, word, None if era is None else torch.from_numpy(era)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(words)
    events = list(prof.profiler.kineto_results.events())

    def stretches(name):
        return [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events if ev.name() == name]

    ((d0, d1),) = stretches("gf.decode")
    within = [st for name in (ERASURE_STAGES if erasures else STAGES) for st in stretches(name)]
    ops = [ev for ev in events if ev.name().startswith("aten::") and d0 <= ev.start_ns() <= d1]
    assert len(ops) > 100
    outside = [ev.name() for ev in ops if not any(s0 <= ev.start_ns() <= s1 for s0, s1 in within)]
    assert set(outside) <= NO_WORK, outside


def test_profiler_events_hold_the_span_names_as_host_ops():
    words = _words("rs255", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(words)
    ours = [s.name for s in _tracing.spans()]
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name().startswith("gf.")]
    assert sorted(ev.name() for ev in events) == sorted(ours)
    for ev in events:
        assert ev.device_type() == torch.autograd.DeviceType.CPU
        if hasattr(ev, "is_user_annotation"):
            assert not ev.is_user_annotation()


def test_spans_record_while_the_profiler_is_paused():
    """The traced run holds a paused profiler until its last seconds."""
    acts = [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    try:
        prof.toggle_collection_dynamic(False, acts)
        with _tracing.span("gf.paused"):
            pass
    finally:
        prof.stop()
    assert [s.name for s in _tracing.spans()] == ["gf.paused"]


def test_matmul_records_binary_matmul():
    F = gt.GF(2**8)
    a, b = F.Random((5, 7), seed=1, device="cpu"), F.Random((7, 3), seed=2, device="cpu")
    want = np.asarray(a @ b)
    with profile(activities=[ProfilerActivity.CPU]):
        got = np.asarray(a @ b)
    recs = _tracing.spans()
    assert [(s.name, s.parent) for s in recs] == [("gf.binary_matmul", None)]
    assert np.array_equal(got, want)


@pytest.mark.parametrize(["name", "erasures"], CASES)
def test_profiler_leaves_results_alone(name, erasures):
    words = _words(name, erasures)
    out_off, cnt_off = _decode(words)
    with profile(activities=[ProfilerActivity.CPU]):
        out_on, cnt_on = _decode(words)
    assert np.array_equal(out_on, out_off) and np.array_equal(cnt_on, cnt_off)
    assert cnt_off.max() > 0


def test_record_stays_bounded():
    extra = 5
    with profile(activities=[ProfilerActivity.CPU]):
        first = None
        for _ in range(_tracing.CAPACITY + extra):
            with _tracing.span("gf.bounded") as s:
                first = s.index if first is None else first
    recs = _tracing.spans()
    assert len(recs) == _tracing.CAPACITY
    assert recs[0].index == first + extra and recs[-1].index == first + _tracing.CAPACITY + extra - 1
    _tracing.clear()
    assert _tracing.spans() == []


def test_a_span_that_raises_leaves_the_nesting_whole():
    with profile(activities=[ProfilerActivity.CPU]):
        with _tracing.span("gf.outer"):
            with pytest.raises(ValueError):
                with _tracing.span("gf.raises"):
                    raise ValueError
            with _tracing.span("gf.inner"):
                pass
        with _tracing.span("gf.after"):
            pass
    recs = {s.name: s for s in _tracing.spans()}
    assert recs["gf.raises"].parent == recs["gf.inner"].parent == recs["gf.outer"].index
    assert recs["gf.after"].parent is None and recs["gf.after"].call == recs["gf.after"].index
