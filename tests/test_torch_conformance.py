"""The JAX package's own public-behaviour test files, run against the torch
port on the CPU.

Each case runs one JAX test file in a subprocess under
``tests/_torch_conformance_plugin.py``, which makes ``galois_tpu`` and its
submodules resolve to ``galois_tpu_torch`` and puts new arrays on the CPU.
The failures must be exactly the file's entry in ``JAX_CALLERS``: the tests
that call ``jax.`` on the package's arrays themselves, which a torch array
cannot serve. Every other test of the file passes or skips as it does for
the JAX package (the golden-vector files skip without their data). Each
subprocess has a time limit, so that a test that never ends fails its case
(and every case of the subprocess it shares; the tail of the verbose log
shows which test it was).

Run one file by hand with
``python -m pytest tests/<file> -p tests._torch_conformance_plugin`` from the
repository root.
"""

import os
import pathlib
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_JIT = "runs port arrays through jax.jit, which takes JAX arrays only (the port's counterpart is CUDA-graph capture)"

# file -> {test id: why it fails against the port}: only tests that call jax. themselves
JAX_CALLERS = {
    "test_api_behavior.py": {
        "test_jit_vmap_pytree": _JIT + " and jax.vmap",
        "test_methods_jit_safe": _JIT,
        "test_is_square_sqrt_jit_safe": _JIT,
    },
}

# (file, whether the case is slow). Tier-1's cases share one subprocess:
# each subprocess spends about 10 s starting (torch, JAX and the port) on a
# shared CPU box, more than most files' tests take; together they take about
# 30 s. The slow cases, left out of tier-1 for its time budget, are the two
# files that take longest (15-35 s of tests each: a GF(2^100) Poly divmod
# and the long Berlekamp-Massey scans); each runs in a subprocess of its own.
SUITES = [
    ("test_api_behavior.py", False),
    ("test_behavioral_matrix.py", False),
    ("test_numpy_contracts.py", False),
    ("test_numpy_functions.py", False),
    ("test_field_laws.py", False),
    ("test_options.py", False),
    ("test_instantiation_matrix.py", False),
    ("test_class_properties_matrix.py", False),
    ("fields/test_golden_arithmetic.py", False),
    ("fields/test_golden_methods.py", False),
    ("fields/test_sqrt.py", False),
    ("polys/test_conway.py", False),
    ("polys/test_golden_polys.py", False),
    ("polys/test_implementations.py", False),
    ("polys/test_limb_fields.py", True),
    ("polys/test_poly_behavior.py", False),
    ("codes/test_bch_codes_table.py", False),
    ("codes/test_bch_golden.py", False),
    ("codes/test_fec_behavior.py", False),
    ("codes/test_rs_golden.py", False),
    ("test_lfsr.py", True),
    ("test_lfsr_matrix.py", False),
    ("test_nt.py", False),
    ("test_luts.py", False),
]
SHARED = tuple(f for f, slow in SUITES if not slow)
# time limits of a subprocess: several times its run time on a shared CPU box
SHARED_LIMIT_S, SLOW_LIMIT_S = 240, 240


def _module(suite: str) -> str:
    return "tests." + suite[: -len(".py")].replace("/", ".")


def _failures(report: pathlib.Path, suite: str):
    """The ids of the failed tests of one file in a junit report, relative
    to the file: ``Class::test[param]`` or ``test[param]``."""
    mod, failed = _module(suite), set()
    for case in ET.parse(report).getroot().iter("testcase"):
        cls = case.get("classname", "")
        if cls != mod and not cls.startswith(mod + "."):
            continue
        if case.find("failure") is not None or case.find("error") is not None:
            inner = cls[len(mod) + 1 :]
            failed.add(f"{inner}::{case.get('name')}" if inner else case.get("name"))
    return failed


@pytest.fixture(scope="module")
def run_suites(tmp_path_factory):
    """Runs a tuple of JAX test files against the port in one subprocess,
    once per tuple: (pytest's exit code or None on timeout, the junit
    report, the tail of its output)."""
    done = {}

    def run(files, limit_s):
        if files not in done:
            report = tmp_path_factory.mktemp("conformance") / "report.xml"
            cmd = [
                sys.executable, "-m", "pytest", *(f"tests/{f}" for f in files), "-v",
                "-p", "tests._torch_conformance_plugin", "-p", "no:cacheprovider", "-p", "no:xdist",
                "-p", "no:randomly", f"--junitxml={report}",
            ]
            env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
            # one torch thread: the subprocess shares the box with the other test workers
            env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
            try:
                out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=limit_s)
                done[files] = (out.returncode, report, (out.stdout + out.stderr)[-4000:])
            except subprocess.TimeoutExpired as e:
                stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout or ""
                done[files] = (None, report, f"did not end within {limit_s} s:\n{stdout[-4000:]}")
        return done[files]

    return run


@pytest.mark.parametrize(
    "suite", [pytest.param(f, marks=[pytest.mark.slow] if slow else [], id=f) for f, slow in SUITES]
)
def test_jax_behaviour_suite_against_port(suite, run_suites):
    files, limit_s = (SHARED, SHARED_LIMIT_S) if suite in SHARED else ((suite,), SLOW_LIMIT_S)
    rc, report, tail = run_suites(files, limit_s)
    assert rc in (0, 1), f"pytest over {files} exited {rc}:\n{tail}"
    assert _failures(report, suite) == set(JAX_CALLERS.get(suite, {})), tail
