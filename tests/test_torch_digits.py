"""Odd extension fields above 2^31 on digit storage in the torch port
against the JAX package: GF(3^30) and GF(7^12).

The port keeps the m base-p digits planar, (m, *shape) int64, where the JAX
package keeps them on a trailing u32 axis; the int representations must be
equal. The same seeded NumPy inputs go through the port's ``DigitExtOps``
(plain torch on the CPU), the JAX package's host field in Python ints, and
for GF(3^30) through the JAX package's device ops (its trailing digits).
"""

import functools

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field as jax_host_field

ORDERS = [3**30, 7**12]
IDS = ["GF(3^30)", "GF(7^12)"]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """The plain versions on the CPU, with one torch thread: the tensors hold
    a few elements, and other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with gt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _fields(q):
    return gt.GF(q), gj.GF(q)


def _ints(q, n, seed, low=0):
    return np.random.default_rng(seed).integers(low, q, n, dtype=np.int64)


def _eq(a, b):
    return np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_field_matches_jax(q):
    Ft, Fj = _fields(q)
    mt, mj = Ft._meta, Fj._meta
    assert (mt.storage, mt.storage_width, mt.irreducible_poly_int, mt.primitive_element_int) == (
        mj.storage, mj.storage_width, mj.irreducible_poly_int, mj.primitive_element_int,
    )
    assert mt.storage_first and mt.torch_dtype.is_floating_point is False
    assert Ft.dtypes == Fj.dtypes and Ft.properties == Fj.properties
    x = Ft(_ints(q, 4, 0))
    assert tuple(x._data.shape) == (Ft.degree, 4)  # planar digits


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_elementwise_matches_jax(q):
    Ft, Fj = _fields(q)
    hf = jax_host_field(Fj._meta)
    xs, ys = _ints(q, 6, 1), _ints(q, 6, 2, low=1)
    x, y = Ft(xs), Ft(ys)
    pairs = [(int(a), int(b)) for a, b in zip(xs, ys)]
    assert _eq(x + y, [hf.add(a, b) for a, b in pairs])
    assert _eq(x - y, [hf.subtract(a, b) for a, b in pairs])
    assert _eq(-x, [hf.negative(int(a)) for a in xs])
    assert _eq(x * y, [hf.multiply(a, b) for a, b in pairs])
    assert _eq(x / y, [hf.divide(a, b) for a, b in pairs])
    assert _eq(np.reciprocal(y), [hf.reciprocal(int(b)) for b in ys])
    assert _eq(y**-2, [hf.power(hf.reciprocal(int(b)), 2) for b in ys])
    e = np.array([0, 1, 2, 7, 2**40 + 3, 12345], dtype=np.int64)
    assert _eq(x**e, [hf.power(int(a), int(k)) for a, k in zip(xs, e)])
    assert _eq(y[1:] ** -e[1:], [hf.power(hf.reciprocal(int(b)), int(k)) for b, k in zip(ys[1:], e[1:])])
    sq = x * x
    r = np.sqrt(sq)
    # the canonical root, as the JAX package picks it: the one whose int repr is the smaller
    assert _eq(r * r, sq) and all(int(a) <= int(b) for a, b in zip(np.asarray(r), np.asarray(-r)))
    assert _eq(x.is_square(), [hf.is_square(int(a)) for a in xs])
    assert (x == x).all() and not (x == y).any()
    assert _eq(x * Ft.characteristic, np.zeros(6, dtype=np.int64))
    with pytest.raises(ZeroDivisionError):
        x / Ft.Zeros(6)


def test_device_ops_match_jax():
    """The JAX package's own device arrays (OddExtOps on trailing digits)."""
    q = 3**30
    Ft, Fj = _fields(q)
    xs, ys = _ints(q, 8, 4), _ints(q, 8, 5, low=1)
    assert _eq(Ft(xs) * Ft(ys), Fj(xs) * Fj(ys))
    assert _eq(Ft(xs) / Ft(ys), Fj(xs) / Fj(ys))
    assert _eq(Ft(xs) - Ft(ys), Fj(xs) - Fj(ys))


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_arrays_match_jax(q):
    Ft, Fj = _fields(q)
    xs = _ints(q, 12, 3).reshape(3, 4)
    xt, xj = Ft(xs), Fj(xs)
    assert str(xt) == str(xj) and repr(xt) == repr(xj)
    assert _eq(xt[1, 2], xs[1, 2]) and _eq(xt[..., 1], xs[..., 1]) and _eq(xt[:, ::2], xs[:, ::2])
    assert _eq(xt[np.array([2, 0])], xs[[2, 0]]) and _eq(xt[xt == xt[0, 0]], [xs[0, 0]])
    assert _eq(xt.reshape(4, 3), xs.reshape(4, 3)) and _eq(xt.T, xs.T) and _eq(xt.flatten(), xs.reshape(-1))
    assert _eq(np.concatenate([xt, xt]), np.concatenate([xs, xs])) and _eq(np.stack([xt, xt]), np.stack([xs, xs]))
    back = Ft.from_numpy(np.asarray(xj))
    assert _eq(back, xs) and back.shape == (3, 4)
    assert _eq(xt.vector(), np.asarray(xj.vector()))
    assert _eq(Ft.Vector(np.asarray(xj.vector())), xs)
    assert _eq(Ft.Ones((2, 2)), np.ones((2, 2), dtype=np.int64)) and _eq(Ft.Identity(3), np.eye(3, dtype=np.int64))
    assert _eq(Ft.Range(5, 9), [5, 6, 7, 8])
    hf = jax_host_field(Fj._meta)
    total = 0
    for v in xs.reshape(-1):
        total = hf.add(total, int(v))
    assert int(np.sum(xt)) == total
    assert _eq(xt.field_trace(), xj.field_trace()) and _eq(xt.field_norm(), xj.field_norm())
    r = Ft.Random((5, 2), seed=2)
    assert r.shape == (5, 2) and all(0 <= int(v) < q for v in np.asarray(r).reshape(-1))
    r = Ft.Random(7, low=q - 10, seed=3)
    assert all(q - 10 <= int(v) < q for v in np.asarray(r))


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_poly_and_linalg_match_jax(q):
    Ft, Fj = _fields(q)
    a, b = _ints(q, 7, 6), _ints(q, 3, 7, low=1)
    pt, pj = gt.Poly(Ft(a)), gj.Poly(Fj(a))
    bt, bj = gt.Poly(Ft(b)), gj.Poly(Fj(b))
    assert str(pt * bt) == str(pj * bj)
    qt, rt = divmod(pt, bt)
    qj, rj = divmod(pj, bj)
    assert str(qt) == str(qj) and str(rt) == str(rj)
    pts = _ints(q, 4, 8)
    assert _eq(pt(Ft(pts)), pj(Fj(pts)))
    A, B = _ints(q, 9, 9).reshape(3, 3), _ints(q, 3, 10)
    At, Aj = Ft(A), Fj(A)
    assert _eq(At @ At, Aj @ Aj) and _eq(At @ Ft(B), Aj @ Fj(B))
    assert _eq(np.linalg.inv(At), np.linalg.inv(Aj))
    assert _eq(np.linalg.solve(At, Ft(B)), np.linalg.solve(Aj, Fj(B)))
    assert int(np.linalg.det(At)) == int(np.linalg.det(Aj))


def test_device_elimination_matches_host():
    """The device column loop of ``ops/_linalg.py`` (which matrices above
    4096 elements take) on planar digits: [A | I] reduces to the host
    route's exact RREF, and the determinant's device PLU to the host's."""
    from galois_tpu_torch.ops import _linalg

    Ft, _ = _fields(7**12)
    meta, mode = Ft._meta, Ft._mode
    A = Ft(_ints(7**12, 36, 11).reshape(6, 6))
    AI = Ft(np.concatenate([np.asarray(A), np.eye(6, dtype=np.int64)], axis=1))
    R, rank = _linalg._row_reduce_data(meta, mode, AI._data, 6)
    R_host, rank_host, _ = _linalg._host_row_reduce(Ft, np.asarray(AI, dtype=object), 6)
    assert int(rank) == rank_host == 6 and _eq(Ft._view(R), R_host)
    assert int(Ft._view(_linalg._det_data(meta, mode, A._data))) == int(np.linalg.det(A))


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_log_matches_jax(q):
    """Digit fields take the host Pohlig-Hellman in both packages."""
    Ft, Fj = _fields(q)
    xs = _ints(q, 3, 12, low=1)
    assert _eq(Ft(xs).log(), Fj(xs).log())
