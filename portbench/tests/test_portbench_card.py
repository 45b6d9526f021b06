"""On a CUDA card: each cell's run end to end (untraced and traced) comes
out correct with every key the result line must hold, and the control, at
a batch a test can hold, comes out not correct."""

import json
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]]


def run(*args):
    p = subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True, text=True, cwd=ROOT,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct(card, workload, trace):
    r, err = run("--workload", workload, "--seed", str(2**31 + 99), "--seconds", "2", "--trace", trace)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r) and list(r)[-1] == "check"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert err.rstrip().splitlines()[-1].startswith("check ")
    if trace == "1":
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
        assert "device_idle_pct" in r["metrics"] and r["breakdown"]["device_ops"]
        for name, m in r["metrics"].items():
            if name.endswith("roofline"):
                assert 0 < m["value"] <= 100
    else:
        assert set(r["metrics"]) == {m["name"] for m in harness.load_spec()["end_to_end"]}


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "portbench/proof.py", "--workload", workload, "--seeds", "1",
                        "--control-seeds", "2", "--precisions", "float8_e4m3fn", "--seconds", "0.5",
                        "--batch", "4096"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["lower"] == {k: 0 for k in harness.LIMITS}
    assert r["upper"]["float8_e4m3fn"]["msg_rows_wrong"] > 0
