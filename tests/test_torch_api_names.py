"""The public names of the torch port against those of the JAX package.

Each package is imported in a fresh interpreter (so that submodules other
tests imported do not show up as attributes), and its public names (``dir``
without a leading underscore) are listed. The JAX package's names that the
port lacks must equal the set written here, so the set can only shrink as
modules are ported; the port's own additions are its device options.
"""

import json
import os
import subprocess
import sys

import pytest

# ROADMAP.md, queue 1 items 4-6: what is still to be ported
MISSING_FROM_PORT = {
    "Array",
    "FLFSR",
    "GLFSR",
    "berlekamp_massey",
    "lfsr",
    "conway_poly",
    "lagrange_poly",
    "primitive_element",
    "primitive_elements",
    "is_primitive_element",
    "normal_element",
    "normal_elements",
    "is_normal_element",
}
ONLY_IN_PORT = {"default_device", "set_default_device"}

_LIST = "import json, {pkg} as p; print(json.dumps(sorted(n for n in dir(p) if not n.startswith('_'))))"


def _public_names(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _LIST.format(pkg=pkg)], capture_output=True, text=True, check=True, env=env, timeout=300,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def names():
    return {pkg: _public_names(pkg) for pkg in ("galois_tpu", "galois_tpu_torch")}


@pytest.mark.parametrize(
    ["have", "lack", "expected"],
    [("galois_tpu", "galois_tpu_torch", MISSING_FROM_PORT), ("galois_tpu_torch", "galois_tpu", ONLY_IN_PORT)],
)
def test_public_names_differ_only_by_the_listed_sets(names, have, lack, expected):
    assert names[have] - names[lack] == expected
