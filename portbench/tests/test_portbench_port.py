"""The harness driving the library on the CPU at a tiny batch: the plain
reference agrees with it, and a run whose timed path is broken underneath
comes out not correct, once for each fault a decode cell can have."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = harness.ROOT
TINY = {  # workload: mix override (a batch that still holds words beyond capacity)
    "rs_ccsds_errors": {"batch": 48, "ring": 2},
    "bch_h261_errors": {"batch": 48, "ring": 2},
    "rs_ccsds_erasures": {"batch": 66, "ring": 2},
}


def run(workload, seconds=0.2, trace=False):
    return harness.run(workload, 2**31 + 17, seconds, trace, "cpu", time.perf_counter(), mix_override=TINY[workload])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_agrees_with_the_library(workload, trace):
    r = run(workload, trace=trace)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "check"
    names = {m["name"] for m in harness.load_spec()["end_to_end"]}
    if not trace:
        assert set(r["metrics"]) == names


def _broken(monkeypatch, fault):
    """Break ``decode`` underneath the harness's timed call."""
    from galois_tpu_torch.codes._linear import _LinearCode

    original = _LinearCode.decode
    seen = {}  # calls on each batch, by its storage

    def decode(self, codeword, erasures=None, output="message", errors=False):
        key = codeword._data.data_ptr()
        seen[key] = seen.get(key, 0) + 1
        out, cnt = original(self, codeword, erasures=erasures, output=output, errors=errors)
        data, cnt = out._data.clone(), cnt.copy()
        B = data.shape[0]
        if fault == "state_unchanged":  # the received words come back as decoded
            data = codeword._data[:, : self.k].clone()
            cnt[:] = 0
        elif fault == "half_batch":  # the second half of the batch is left out
            data[B // 2 :] = codeword._data[B // 2 :, : self.k]
            cnt[B // 2 :] = 0
        elif fault == "answer_altered_first":  # every call alters one symbol
            data[1, 0] ^= 1
        elif fault == "answer_altered_later" and seen[key] == 4:  # one later call on a batch
            data[1, 0] ^= 1
        elif fault == "count_altered":
            cnt[2] += 1
        return type(out)._view(data), cnt

    monkeypatch.setattr(_LinearCode, "decode", decode)


FAULTS = ["state_unchanged", "half_batch", "answer_altered_first", "answer_altered_later", "count_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    _broken(monkeypatch, fault)
    # a warm-up call on each batch of the ring, then the window's: the fourth
    # call on a batch is the window's third on it, held to its first
    later = fault == "answer_altered_later"
    r = run(workload, seconds=3.0 if later else 0.2)
    if later:
        assert r["attempted"] >= 2 * TINY[workload]["ring"] + 1
    assert not r["correct"], r["check"]
    assert r["failed"] > 0


def test_control_is_not_correct():
    """The control at the cell's kind, tiny: the reference with float8 plane sums."""
    r = harness.run("rs_ccsds_errors", 5, 0.0, False, "cpu", time.perf_counter(),
                    mix_override=TINY["rs_ccsds_errors"], control="float8_e4m3fn")
    assert not r["correct"] and r["check"]["msg_rows_wrong"]["value"] > 0


def test_run_refuses_without_a_card():
    """run.py exits with 2 and prints no result where torch sees no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "rs_ccsds_errors",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rs_ccsds_errors", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""


GUARD = """
import sys, time
sys.path.insert(0, {root!r})
from portbench import harness
{body}
bad = harness.forbidden_modules()
print("BAD" if bad else "OK", bad)
"""


@pytest.mark.parametrize("body", [
    # a whole CPU drive of a cell, the library included
    "harness.run('bch_h261_errors', 3, 0.1, False, 'cpu', time.perf_counter(), mix_override={'batch': 32, 'ring': 2})",
    # the reference and the generator alone load nothing of the library
    "import portbench.reference.cyclic_codes, portbench.traffic\n"
    "assert not [m for m in sys.modules if m.split('.')[0] == 'galois_tpu_torch'], 'the reference loaded the library'",
])
def test_no_jax_and_no_jax_package(body):
    """Compared by whole top-level names: galois_tpu_torch begins with galois_tpu."""
    p = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT), body=body)], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "OK []"


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("galois_tpu_torch_lookalike", None)
    try:
        assert "galois_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("galois_tpu_torch_lookalike", None)
