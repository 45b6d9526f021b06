"""The public names of the torch port against those of the JAX package.

Each package is imported in a fresh interpreter (so that submodules other
tests imported do not show up as attributes), and its public names (``dir``
without a leading underscore) are listed. The JAX package's names that the
port lacks must equal the set written here, so the set can only shrink as
modules are ported; the port's own additions are its device options. The
same holds one level down, for the public names of a field's metaclass,
of ``FieldArray`` and of an instance (GF(7) in both packages).
"""

import json
import os
import subprocess
import sys

import pytest

# ROADMAP.md, queue 1: what is still to be ported (nothing at the top level)
MISSING_FROM_PORT = set()
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


# nothing: the element reprs and the tables built on them are ported
MISSING_FROM_PORT_META = set()
# ``jax``, the JAX storage array; the port's storage is a torch tensor, on ``device``
MISSING_FROM_PORT_ARRAY = {"jax"}
ONLY_IN_PORT_ARRAY = {"device", "from_numpy"}

_LIST_FIELD = (
    "import json, {pkg} as p; F = p.GF(7); x = F([1, 2]) if '{pkg}' == 'galois_tpu' else F([1, 2], device='cpu'); "
    "pub = lambda o: sorted(n for n in dir(o) if not n.startswith('_')); "
    "print(json.dumps({{'meta': pub(type(F)), 'FieldArray': pub(p.FieldArray), 'instance': pub(x)}}))"
)


@pytest.fixture(scope="module")
def field_names():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("galois_tpu", "galois_tpu_torch"):
        run = subprocess.run(
            [sys.executable, "-c", _LIST_FIELD.format(pkg=pkg)], capture_output=True, text=True, check=True, env=env, timeout=300,
        )
        out[pkg] = {k: set(v) for k, v in json.loads(run.stdout.strip().splitlines()[-1]).items()}
    return out


@pytest.mark.parametrize(
    ["level", "missing", "only_in_port"],
    [
        ("meta", MISSING_FROM_PORT_META, set()),
        ("FieldArray", MISSING_FROM_PORT_ARRAY, ONLY_IN_PORT_ARRAY),
        ("instance", MISSING_FROM_PORT_ARRAY, ONLY_IN_PORT_ARRAY),
    ],
)
def test_field_names_differ_only_by_the_listed_sets(field_names, level, missing, only_in_port):
    jax_names, port_names = field_names["galois_tpu"][level], field_names["galois_tpu_torch"][level]
    assert jax_names - port_names == missing
    assert port_names - jax_names == only_in_port
