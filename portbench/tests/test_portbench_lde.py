"""The ``ntt_lde`` kind: its entries in BENCHMARK.json, its map, its column
generator, the harness driving it on the CPU at a tiny N (correct, and not
correct for each fault a run can have and for the control), its span
metrics on synthetic records; on a CUDA card, the cell's traced run and its
control at the cell's own size."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.kinds import ntt_lde
from portbench.maps import ntt_lde as lde_map
from portbench.metrics import _by_span
from portbench.reference import goldilocks_ntt as ref

ROOT = harness.ROOT
SPEC = harness.load_spec()
CELL = "goldilocks_lde_cols4"
CONFIG = "goldilocks_zkevm_lde23"
SPAN_METRICS = {
    "lde_int8_products_ms_per_call": "gf.limb_matmul.products",
    "lde_limb_combine_ms_per_call": "gf.limb_matmul.combine",
    "lde_twiddle_ms_per_call": "gf.ntt.twiddle",
}
# the accepted metrics whose generic readers find the LDE's device work, the cell appended to their lists
SHARED_METRICS = ["device_idle_pct", "launches_per_call", "gemm_ms_per_call", "torch_pass_ms_per_call",
                  "hand_kernel_ms_per_call", "call_roofline", "wrapper_launches_per_call", "python_gap_ms_per_call"]
DECODE_CELLS = ["rs_ccsds_errors", "bch_h261_errors", "rs_ccsds_erasures"]


def test_the_benchmark_holds_one_config_one_cell_and_three_metrics():
    (config,) = [c for c in SPEC["configs"] if c["name"] == CONFIG]
    assert config["reduced"] == [] and config["file"] == f"portbench/configs/{CONFIG}.json"
    (cell,) = [w for w in SPEC["workloads"] if w["config"] == CONFIG]
    assert cell == {**cell, "name": CELL, "traffic": "zkevm_lde_cols4", "chips": 1}
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["workloads"] == [CELL] and entries[name]["moves"] == "items_per_s"
    assert {entries[n]["source"] for n in SPAN_METRICS} == {"program_span"}
    for name in SHARED_METRICS:
        assert entries[name]["workloads"] == [*DECODE_CELLS, CELL]
    assert [m["name"] for m in SPEC["per_layer"] if CELL in m["workloads"]] == [*SHARED_METRICS, *SPAN_METRICS]
    _, cfg, mix = harness.cell_parts(SPEC, CELL)
    assert (cfg["kind"], cfg["roofline_map"], cfg["p"], cfg["n"], cfg["blowup"]) == ("ntt_lde", "ntt_lde", ref.P,
                                                                                    2**23, 2)
    assert 2 ** cfg["n_bits"] == cfg["n"] and 2 ** cfg["n_bits_ext"] == cfg["n"] * cfg["blowup"]
    assert (mix["batch"], mix["ring"]) == (4, 2) and cfg["batch_max"] == mix["batch"]


def test_map_counts_each_column_read_and_written_once():
    _, cfg, mix = harness.cell_parts(SPEC, CELL)
    n = 2**23
    assert lde_map.bytes_per_call(cfg, mix) == 4 * (n * 8 + 2 * n * 8) + n * 8
    assert lde_map.bytes_per_call(cfg, {**mix, "batch": 4096}) == lde_map.bytes_per_call(cfg, mix)


@pytest.mark.parametrize("batch", [1, 4, 4096])
def test_a_call_holds_at_most_batch_max_columns(batch):
    """A batch above the configuration's ``batch_max`` (as ``proof.py --batch``
    may ask) is cut to it; the ring and the call hold that many columns."""
    cell = _cell(n=64, batch=batch)
    held = min(batch, 4)
    assert cell.items_per_call == held
    ring = cell.make_ring(2**31 + 3)
    assert [tuple(s.limbs.shape) for s in ring] == [(4, held, 64)] * 2
    out, cnt = cell.call(ring[0])
    assert tuple(out.shape) == (held, 4 * 128) and cnt.shape == (held,)


def test_columns_are_uniform_field_elements_from_the_seed():
    def draw(seed):
        return ntt_lde.make_columns(3, 4096, torch.Generator().manual_seed(seed))

    hi, lo = draw(2**31 + 5)
    assert bool((hi >= 0).all() and (hi < 2**32).all() and (lo >= 0).all() and (lo < 2**32).all())
    assert not bool(((hi == 2**32 - 1) & (lo >= 1)).any())
    again = draw(2**31 + 5)
    assert torch.equal(hi, again[0]) and torch.equal(lo, again[1])
    assert not torch.equal(hi, draw(7)[0])


def _cell(n=64, batch=3, control=None):
    _, cfg, mix = harness.cell_parts(SPEC, CELL)
    return ntt_lde.Cell({**cfg, "n": n}, {**mix, "batch": batch}, "cpu", control=control)


def _run(cell, seconds=0.2, seed=2**31 + 17):
    ring = cell.make_ring(seed)
    for slot in ring:  # the warm-up call on each batch, as the harness makes
        cell.call(slot)
    w = harness.measure(cell, ring, seconds, time.perf_counter())
    return harness.check(cell, ring, w), w


@pytest.mark.parametrize("n", [64, 2**12])
def test_the_kind_agrees_with_the_reference(n):
    checks, w = _run(_cell(n))
    assert all(c["value"] == 0 for c in checks[0].values()), checks
    assert checks[1] == 0 and w.calls >= 2


def _broken(monkeypatch, fault):
    """Break the forward transform underneath the timed call."""
    from galois_tpu_torch.ops import _ntt

    original = _ntt.field_fft
    calls = [0]

    def field_fft(x, n=None, axis=-1, norm=None):
        out = original(x, n=n, axis=axis, norm=norm)
        calls[0] += 1
        data = out._data.clone()
        if fault == "state_unchanged":  # the padded coefficients come back untransformed
            data = _ntt._pad_or_trim(x, n)._data.clone()
        elif fault == "half_batch":  # the last column is left out
            data[:, -1] = 0
        elif fault == "answer_altered_first":
            data[0, 1, 5] ^= 1
        elif fault == "answer_altered_later" and calls[0] == 6:  # a later call: two warm-ups, two firsts
            data[0, 1, 5] ^= 1
        return type(out)._view(data)

    monkeypatch.setattr(_ntt, "field_fft", field_fft)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered_first", "answer_altered_later"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    (checks, failed), w = _run(_cell(), seconds=1.0)
    assert w.calls >= 4
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    assert failed > 0 and checks["count_rows_wrong"]["value"] == 0


@pytest.mark.parametrize("precision", ["float64", "float32", "tfloat32", "bfloat16", "float16", "float8_e4m3fn"])
def test_control_is_not_correct(precision):
    (checks, failed), _ = _run(_cell(control=precision), seconds=0.0)
    assert checks["msg_rows_wrong"]["value"] == 2 * 3 and failed > 0  # every column of both batches


def _records():
    def rec(i, name, device_ms):
        return SimpleNamespace(index=i, name=name, call=0, parent=None, start_ns=0, end_ns=1, device_ms=device_ms)

    names = ["gf.ntt", "gf.limb_matmul.products", "gf.limb_matmul.combine", "gf.ntt.twiddle",
             "gf.limb_matmul.products", "gf.ntt.twiddle", "gf.decode"]
    return [rec(i, n, 1.5 * (i + 1)) for i, n in enumerate(names)] + [rec(9, "gf.ntt.twiddle", None)]


def test_span_metrics_divide_by_the_windows_calls(monkeypatch):
    recs = _records()
    monkeypatch.setattr(_by_span, "records", lambda: recs)
    run = SimpleNamespace(window_calls=4)
    want = {"lde_int8_products_ms_per_call": (3.0 + 7.5) / 4, "lde_limb_combine_ms_per_call": 4.5 / 4,
            "lde_twiddle_ms_per_call": (6.0 + 9.0) / 4}
    for metric in SPAN_METRICS:
        assert harness.load_reader("metrics", metric).read(run) == pytest.approx(want[metric]), metric
        assert harness.load_reader("metrics", metric).read(SimpleNamespace(window_calls=0)) is None


def test_a_program_without_the_spans_gives_no_metric(monkeypatch):
    """The parent program has spans, none of these names; an older one has
    no span module."""
    run = SimpleNamespace(window_calls=4)
    monkeypatch.setattr(_by_span, "records", lambda: [r for r in _records() if r.name == "gf.decode"])
    for metric in SPAN_METRICS:
        assert harness.load_reader("metrics", metric).read(run) is None
    monkeypatch.undo()
    monkeypatch.setattr(_by_span, "PACKAGE", "no_such_program")
    for metric in SPAN_METRICS:
        assert harness.load_reader("metrics", metric).read(run) is None


def test_call_roofline_reads_the_lde_map():
    ms = 100.0
    digest = SimpleNamespace(calls=2, ops=[("kernel", "k", 0, int(2 * ms * 1e6))])
    _, cfg, mix = harness.cell_parts(SPEC, CELL)
    run = SimpleNamespace(digest=digest, device_name="NVIDIA H100 80GB HBM3", config=cfg, mix=mix)
    got = harness.load_reader("metrics", "call_roofline").read(run)
    assert got == pytest.approx(100 * lde_map.bytes_per_call(cfg, mix) / 3.35e12 / (ms / 1e3))


@pytest.mark.card
def test_traced_cell_reports_the_new_metrics(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", str(2**31 + 24),
                        "--seconds", "4", "--trace", "1"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    assert {*SPAN_METRICS, *SHARED_METRICS} == set(r["metrics"]), sorted(r["metrics"])
    assert 0 < r["metrics"]["call_roofline"]["value"] <= 100


@pytest.mark.card
def test_control_is_not_correct_at_the_cells_size(card):
    p = subprocess.run([sys.executable, "portbench/proof.py", "--workload", CELL, "--seeds", "1",
                        "--control-seeds", "2", "--precisions", "float64", "--seconds", "0.5", "--batch", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["lower"] == {k: 0 for k in harness.LIMITS}
    assert r["upper"]["float64"]["msg_rows_wrong"] > 0


def test_the_kind_loads_nothing_of_jax():
    body = ("import sys, time\nsys.path.insert(0, {root!r})\nfrom portbench import harness\n"
            "from portbench.tests.test_portbench_lde import _cell, _run\n_run(_cell())\n"
            "print('BAD' if harness.forbidden_modules() else 'OK')")
    p = subprocess.run([sys.executable, "-c", body.format(root=str(ROOT))], capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "OK"
