"""Kernel K8 of the torch port: the GF(2^m) multiply, 2 <= m <= 8.

Its plain torch version, the TPU kernel's SWAR algorithm with four elements
per 32-bit word (what CPU tensors run, and what the kernel, which reads the
field's tables, is held against on the card), against the JAX package's ``_swar_mul_core``, called on
numpy-packed words as ``tests/test_pallas.py`` calls it, and against the
port's one-element ladder (K7's plain version), for every m, the default
(Conway) and another irreducible f, sizes 0, 1, 3 and 4099 and broadcast
operands; the routing of ``BinaryExtOps.multiply`` by field. Inputs are made
with numpy from a seed; the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.ops._pallas._elementwise import _swar_mul_core
from galois_tpu_torch.ops import _kernels
from galois_tpu_torch.ops._elementwise import (
    gf2m_multiply_plain,
    gf2m_multiply_swar,
    gf2m_multiply_swar_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _polys(m):
    """The field's default f and, where there is one, another irreducible f."""
    f = gj.GF(2**m)._meta.irreducible_poly_int
    other = int(gj.irreducible_poly(2, m, method="max"))
    return [f] if other == f else [f, other]


def _jax_swar(a: np.ndarray, b: np.ndarray, m: int, f: int) -> np.ndarray:
    import jax.numpy as jnp

    n = a.size
    pad = (-n) % 4
    A = jnp.asarray(np.concatenate([a, np.zeros(pad, np.uint8)]).view(np.uint32))
    B = jnp.asarray(np.concatenate([b, np.zeros(pad, np.uint8)]).view(np.uint32))
    return np.asarray(_swar_mul_core(A, B, m, f)).view(np.uint8)[:n]


@pytest.mark.parametrize("m", range(2, 9))
@pytest.mark.parametrize("n", [0, 1, 3, 4099])
def test_swar_plain_matches_jax_core_and_ladder(m, n):
    rng = np.random.default_rng(100 * m + n)
    a = rng.integers(0, 2**m, n).astype(np.uint8)
    b = rng.integers(0, 2**m, n).astype(np.uint8)
    a[: min(n, 2)] = [0, 2**m - 1][: min(n, 2)]
    for f in _polys(m):
        got = gf2m_multiply_swar_plain(torch.from_numpy(a), torch.from_numpy(b), m, f)
        assert got.dtype == torch.uint8 and got.shape == (n,)
        assert np.array_equal(got.numpy(), _jax_swar(a, b, m, f))
        ladder = gf2m_multiply_plain(torch.from_numpy(a), torch.from_numpy(b), m, f)
        assert torch.equal(got, ladder)


@pytest.mark.parametrize("m", [3, 8])
def test_swar_plain_broadcasts(m):
    rng = np.random.default_rng(m)
    f = _polys(m)[-1]
    a = torch.from_numpy(rng.integers(0, 2**m, (5, 1, 7)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 2**m, (3, 1)).astype(np.uint8))
    s = torch.tensor(2**m - 1, dtype=torch.uint8)  # a 0-D operand
    for x, y in ((a, b), (b, a), (a, s), (s, b)):
        got = gf2m_multiply_swar(x, y, m, f)
        want = gf2m_multiply_plain(*torch.broadcast_tensors(x, y), m, f)
        assert got.shape == torch.broadcast_shapes(x.shape, y.shape) and torch.equal(got, want)


def test_swar_wrapper_uses_plain_on_cpu_only_and_checks_its_operands():
    F = gt.GF(2**8)
    f = F._meta.irreducible_poly_int
    a = torch.arange(256, dtype=torch.uint8)
    before = gf2m_multiply_swar.launches
    assert torch.equal(gf2m_multiply_swar(a, a.flip(0), 8, f), gf2m_multiply_plain(a, a.flip(0), 8, f))
    assert gf2m_multiply_swar.launches == before  # the plain version is no launch
    with pytest.raises(ValueError):  # not CPU and not CUDA: raise rather than fall back
        gf2m_multiply_swar(a.to("meta"), a.to("meta"), 8, f)
    with pytest.raises(TypeError):
        gf2m_multiply_swar(a.to(torch.int64), a.to(torch.int64), 8, f)
    with pytest.raises(ValueError):
        gf2m_multiply_swar(a, a, 9, 0x211)


@pytest.mark.parametrize(["m", "kernel"], [(2, "gf2m_multiply_swar"), (8, "gf2m_multiply_swar"), (9, "gf2m_multiply"), (16, "gf2m_multiply")])
def test_binary_multiply_routes_by_field(monkeypatch, m, kernel):
    """GF(2^m) x * y takes K8's wrapper for m <= 8 and K7's for 9 <= m <= 16,
    on any device: the CPU runs the card's routing."""
    calls = []
    for name in ("gf2m_multiply_swar", "gf2m_multiply"):
        real = getattr(_kernels, name)
        monkeypatch.setattr(_kernels, name, lambda *args, real=real, name=name: (calls.append(name), real(*args))[1])
    Ft, Fj = gt.GF(2**m), gj.GF(2**m)
    rng = np.random.default_rng(m)
    x, y = rng.integers(0, 2**m, 300), rng.integers(0, 2**m, 300)
    got = Ft(x) * Ft(y)
    assert calls == [kernel]
    assert np.array_equal(np.asarray(got), np.asarray(Fj(x) * Fj(y)))
