"""Linear algebra over GF(q) of the torch port against the JAX package:
the public boundary on small matrices (the host elimination, A.size <=
4096), and the char and min polys of matrices on both sides of their
cutoffs (n = 31 and 32 for the char poly, 32 and 33 for the min poly).

Row reduction, rank, inverse, determinant, solve, PLU and LU, the four
spaces, matrix powers, dot products, field sums and products, the trace and
a few shape pass-throughs, over GF(2), GF(2^4), GF(2^8) (calculate and
lookup modes), GF(3^5), GF(7), GF(2^31 - 1) and the Goldilocks field (planar
limbs). The same inputs, made with numpy from a seed, go through
``galois_tpu`` and ``galois_tpu_torch``; the tolerance is exact integer
equality of ``np.asarray`` results, and the exception types must agree. The
device route of the elimination (A.size > 4096) is in
``tests/test_torch_linalg_device.py``, which shares this file's helpers; the
two files are apart so that test workers can run them side by side.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu.ops import _charpoly as jax_charpoly
from galois_tpu.ops import _linalg as jl
from galois_tpu.ops import _minpoly as jax_minpoly
from galois_tpu_torch.fields import _factory as torch_factory
from galois_tpu_torch.ops import _charpoly, _minpoly

REPO = Path(__file__).resolve().parents[1]
M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1

# (id, order, mode)
FIELDS = [
    ("GF2", 2, "jit-calculate"),
    ("GF16", 2**4, "jit-calculate"),
    ("GF256", 2**8, "jit-calculate"),
    ("GF256-lookup", 2**8, "jit-lookup"),
    ("GF243", 3**5, "jit-calculate"),
    ("GF7", 7, "jit-calculate"),
    ("M31", M31, "jit-calculate"),
    ("Goldilocks", GOLDILOCKS, "jit-calculate"),
]
FIELD_IDS = [f[0] for f in FIELDS]
BY_ID = {f[0]: f for f in FIELDS}


@pytest.fixture(autouse=True, scope="module")
def _on_cpu_and_restore_modes():
    """The plain versions serve CPU tensors: ask for the CPU, since new data
    goes to CUDA by default. Put every cached field class back in its mode,
    so that no lookup-mode class leaks into later tests of this worker."""
    caches = (jax_factory._FIELD_CACHE, torch_factory._FIELD_CACHE)
    saved = [{k: cls._mode for k, cls in c.items()} for c in caches]
    with gt.default_device("cpu"):
        yield
    for cache, modes in zip(caches, saved):
        for k, cls in cache.items():
            cls._mode = modes.get(k, cls._meta.default_ufunc_mode)


def _fields(fid):
    _, q, mode = BY_ID[fid]
    return gt.GF(q, compile=mode), gj.GF(q, compile=mode)


def _ints(q, shape, rng):
    """Uniform int reprs of GF(q): int64, or object ints above 2^62."""
    if q <= 2**62:
        return rng.integers(0, q, shape, dtype=np.int64)
    hi, lo = (rng.integers(0, 2**32, shape).astype(object) for _ in range(2))
    return (hi * 2**32 + lo) % q


def _pair(fid, arr):
    Ft, Fj = _fields(fid)
    return Ft(arr), Fj(arr)


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(object), want.astype(object))


def _same_poly(p_torch, p_jax):
    assert p_torch.degree == p_jax.degree
    assert [int(c) for c in np.asarray(p_torch.coefficients(), dtype=object)] == [
        int(c) for c in np.asarray(p_jax.coefficients(), dtype=object)
    ]


def _raises_alike(fn_torch, fn_jax):
    with pytest.raises(Exception) as et:
        fn_torch()
    with pytest.raises(Exception) as ej:
        fn_jax()
    assert et.type is ej.type, (et.value, ej.value)


def _invertible(fid, n, seed):
    """A random n x n matrix of full rank: over fields of order <= 16, draws
    until the JAX package's host elimination finds rank n; above, one draw
    (singular with a chance below 1/240; the comparisons with the JAX
    package would fail on it)."""
    _, Fj = _fields(fid)
    rng = np.random.default_rng(seed)
    while True:
        A = _ints(Fj.order, (n, n), rng)
        if Fj.order > 16 or jl._host_row_reduce(Fj, A.astype(object), n)[1] == n:
            return A


def _deficient(fid, shape, seed):
    """A random matrix with a zero column, a column repeated and a row that
    is the sum of two others: columns without a pivot and rank < rows."""
    Ft, _ = _fields(fid)
    rng = np.random.default_rng(seed)
    A = _ints(Ft.order, shape, rng).astype(object)
    A[:, 1] = 0
    A[:, 4] = A[:, 2]
    A[3] = np.asarray(Ft(A[0].tolist()) + Ft(A[2].tolist()), dtype=object)
    return A


# ----------------------------------------------------------------------
# The host route (A.size <= 4096) at the public boundary
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fid", FIELD_IDS)
def test_row_reduce_and_rank_match_jax(fid):
    At, Aj = _pair(fid, _deficient(fid, (5, 7), 1))
    for eye in ("left", "right"):
        _same(At.row_reduce(eye=eye), Aj.row_reduce(eye=eye))
        _same(At.row_reduce(ncols=4, eye=eye), Aj.row_reduce(ncols=4, eye=eye))
    assert np.linalg.matrix_rank(At) == np.linalg.matrix_rank(Aj)
    Bt, Bj = _pair(fid, _invertible(fid, 5, 2))
    _same(Bt.row_reduce(), Bj.row_reduce())
    assert np.linalg.matrix_rank(Bt) == np.linalg.matrix_rank(Bj) == 5
    _raises_alike(lambda: At[0].row_reduce(), lambda: Aj[0].row_reduce())
    # the caller's dtype is kept by every result (the JAX package falls back to
    # its default dtype in some of them); the values are the JAX package's
    Ft, _ = _fields(fid)
    dt = Ft.dtypes[-1]
    Dt = Ft(_deficient(fid, (5, 7), 1), dtype=dt)
    for eye in ("left", "right"):
        R = Dt.row_reduce(eye=eye)
        _same(R, Aj.row_reduce(eye=eye))
        assert R.dtype == dt
    Et = Ft(np.asarray(Bt, dtype=object), dtype=dt)
    for X in (np.trace(Et), np.linalg.inv(Et), np.linalg.det(Et), *Et.plu_decompose()):
        assert X.dtype == dt


@pytest.mark.parametrize("fid", FIELD_IDS)
def test_inv_det_solve_match_jax(fid):
    Ft, Fj = _fields(fid)
    A = _invertible(fid, 4, 3)
    At, Aj = Ft(A), Fj(A)
    _same(np.linalg.inv(At), np.linalg.inv(Aj))
    _same(np.linalg.det(At), np.linalg.det(Aj))
    _same(np.linalg.det(At[:1, :1]), np.linalg.det(Aj[:1, :1]))  # n = 1
    _same(np.linalg.det(At[:2, :2]), np.linalg.det(Aj[:2, :2]))
    b = _ints(Ft.order, (4,), np.random.default_rng(4))
    _same(np.linalg.solve(At, Ft(b)), np.linalg.solve(Aj, Fj(b)))
    S = _deficient(fid, (5, 5), 5)
    St, Sj = Ft(S), Fj(S)
    _same(np.linalg.det(St), np.linalg.det(Sj))
    _raises_alike(lambda: np.linalg.inv(St), lambda: np.linalg.inv(Sj))
    _raises_alike(lambda: np.linalg.inv(At[:, :3]), lambda: np.linalg.inv(Aj[:, :3]))
    _raises_alike(lambda: np.linalg.det(At[:, :3]), lambda: np.linalg.det(Aj[:, :3]))


@pytest.mark.parametrize("fid", FIELD_IDS)
def test_plu_and_lu_match_jax(fid):
    Ft, Fj = _fields(fid)
    for A in (_invertible(fid, 5, 6), _deficient(fid, (5, 5), 7)):
        for got, want in zip(Ft(A).plu_decompose(), Fj(A).plu_decompose()):
            _same(got, want)
    # a matrix that needs no row exchange has an LU decomposition; one that does has not
    L = np.tril(_ints(Ft.order, (4, 4), np.random.default_rng(8)).astype(object), -1)
    np.fill_diagonal(L, 1)
    U = np.triu(_invertible(fid, 4, 9).astype(object))
    np.fill_diagonal(U, [1, 2 % Ft.order or 1, 1, 1])
    A = np.asarray(Fj(L) @ Fj(U), dtype=object)
    for got, want in zip(Ft(A).lu_decompose(), Fj(A).lu_decompose()):
        _same(got, want)
    B = A[[1, 0, 2, 3]]
    B[0, 0] = 0
    B[1, 0] = 1
    _raises_alike(lambda: Ft(B).lu_decompose(), lambda: Fj(B).lu_decompose())


@pytest.mark.parametrize("fid", FIELD_IDS)
def test_spaces_match_jax(fid):
    for A in (_deficient(fid, (5, 7), 10), _deficient(fid, (7, 5), 11), _invertible(fid, 4, 12)):
        At, Aj = _pair(fid, A)
        for name in ("row_space", "column_space", "left_null_space", "null_space"):
            _same(getattr(At, name)(), getattr(Aj, name)())


@pytest.mark.parametrize("fid", FIELD_IDS)
def test_products_and_reductions_match_jax(fid):
    Ft, Fj = _fields(fid)
    rng = np.random.default_rng(13)
    A, x, y = _ints(Ft.order, (4, 4), rng), _ints(Ft.order, (4,), rng), _ints(Ft.order, (3,), rng)
    At, Aj, xt, xj, yt, yj = Ft(A), Fj(A), Ft(x), Fj(x), Ft(y), Fj(y)
    for n in (0, 1, 3, 6):
        _same(np.linalg.matrix_power(At, n), np.linalg.matrix_power(Aj, n))
    B = _invertible(fid, 4, 14)
    _same(np.linalg.matrix_power(Ft(B), -3), np.linalg.matrix_power(Fj(B), -3))
    _same(np.dot(At, xt), np.dot(Aj, xj))
    _same(np.dot(xt, xt), np.dot(xj, xj))
    _same(At.dot(At), Aj.dot(Aj))
    _same(np.inner(xt, xt), np.inner(xj, xj))
    _same(np.outer(xt, yt), np.outer(xj, yj))
    _same(np.vdot(At[:1], At[:1]), np.vdot(Aj[:1], Aj[:1]))
    _same(At.sum(), Aj.sum())
    _same(At.prod(axis=1), Aj.prod(axis=1))
    _same(np.sum(At, axis=0), np.sum(Aj, axis=0))
    _same(np.prod(xt), np.prod(xj))
    C = _ints(Ft.order, (7, 3), np.random.default_rng(15))
    _same(Ft(C).sum(axis=0), Fj(C).sum(axis=0))  # an odd length: the tree's carried element
    _same(Ft(C).prod(axis=0), Fj(C).prod(axis=0))
    if Ft.order <= 2**62:
        _same(np.trace(At), np.trace(Aj))
    else:  # the JAX package's np.trace goes through int64
        _same(np.trace(At), Fj(np.diagonal(np.asarray(Aj, dtype=object)).tolist()).sum())


@pytest.mark.parametrize("fid", FIELD_IDS)
def test_array_pieces_and_passthroughs_match_jax(fid):
    Ft, Fj = _fields(fid)
    rng = np.random.default_rng(16)
    A, B = _ints(Ft.order, (2, 3, 4), rng), _ints(Ft.order, (2, 3, 4), rng)
    At, Aj, Bt, Bj = Ft(A), Fj(A), Ft(B), Fj(B)
    _same(Ft.Ones((2, 3)), Fj.Ones((2, 3)))
    _same(Ft.Identity(3), Fj.Identity(3))
    _same(At.flatten(), Aj.flatten())
    _same(At.ravel(), Aj.ravel())
    _same(At.transpose(), Aj.transpose())
    _same(At.transpose(1, 0, 2), Aj.transpose(1, 0, 2))
    _same(At.transpose((2, 0, 1)), Aj.transpose((2, 0, 1)))
    if Ft.order <= 2**62:  # the JAX package's pass-throughs go through int64
        for fn in (
            lambda x, y: np.concatenate([x, y], axis=1),
            lambda x, y: np.stack([x, y]),
            lambda x, y: np.reshape(x, (4, 6)),
            lambda x, y: np.flip(x, axis=2),
            lambda x, y: np.transpose(y),
            lambda x, y: np.tril(x[0]),
            lambda x, y: np.split(x, 2, axis=2),
        ):
            got, want = fn(At, Bt), fn(Aj, Bj)
            if isinstance(want, list):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    _same(g, w)
            else:
                assert isinstance(got, Ft)
                _same(got, want)
        assert np.count_nonzero(At) == np.count_nonzero(Aj)
        assert np.array_equal(At, Bt) == np.array_equal(Aj, Bj)
    _raises_alike(lambda: np.linalg.eig(At[0, :, :3]), lambda: np.linalg.eig(Aj[0, :, :3]))


# ----------------------------------------------------------------------
# Char and min polys of matrices
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fid", ["GF2", "GF256", "GF7"])
def test_char_and_min_poly_routes_match_jax(fid):
    """Both packages' routes: charpoly at n = 31 (host Berkowitz) and 32
    (the device); minpoly at n = 32 (host) and 33 (the device Krylov
    dependence); and ``charpoly_data`` and ``krylov_minpoly_data`` directly
    at those shapes, with a vector whose dependence comes early."""
    Ft, Fj = _fields(fid)
    rng = np.random.default_rng(30)
    for n in (31, 32) if Ft.order < 2**8 else (32,):  # Berkowitz in Python ints is O(n^4)
        A = _ints(Ft.order, (n, n), rng)
        _same_poly(Ft(A).characteristic_poly(), Fj(A).characteristic_poly())
    _same(Ft._view(_charpoly.charpoly_data(Ft._meta, Ft._mode, Ft(A)._data)),
          Fj._view(jax_charpoly.charpoly_data(Fj._meta, Fj._mode, Fj(A)._data)))
    # block-diagonal matrices: the min poly has degree 4 or 5 < n, so the
    # device route needs the lcm over vectors and m(A) == 0
    blk = _ints(Ft.order, (4, 4), rng)
    D = np.kron(np.eye(8, dtype=np.int64), blk)
    _same_poly(Ft(D).minimal_poly(), Fj(D).minimal_poly())
    for D in (np.pad(D, ((0, 1), (0, 1))), _ints(Ft.order, (33, 33), rng)):
        _same_poly(Ft(D).minimal_poly(), Fj(D).minimal_poly())
        for v in (_ints(Ft.order, (33,), rng), np.eye(33, dtype=np.int64)[5], np.zeros(33, dtype=np.int64)):
            c, d = _minpoly.krylov_minpoly_data(Ft._meta, Ft._mode, Ft(D)._data, Ft(v)._data)
            cj, dj = jax_minpoly.krylov_minpoly_data(Fj._meta, Fj._mode, Fj(D)._data, Fj(v)._data)
            assert int(d) == int(dj)
            _same(Ft._view(c), Fj._view(cj))


@pytest.mark.parametrize("fid", ["GF16", "GF256-lookup", "M31"])
def test_char_and_min_poly_device_match_jax_host(fid, monkeypatch):
    """The port's device char poly (n = 32) and min poly (n = 33) against the
    JAX package's host loops on the same matrices (its device routes turned
    off); the min poly's matrix is block diagonal, so the host solve stays
    small and the lcm over the Krylov candidates and m(A) == 0 run."""
    Ft, Fj = _fields(fid)
    monkeypatch.setattr(jax_charpoly, "supports", lambda meta: False)
    monkeypatch.setattr(jax_minpoly, "supports", lambda meta: False)
    rng = np.random.default_rng(31)
    A = _ints(Ft.order, (32, 32), rng)
    _same_poly(Ft(A).characteristic_poly(), Fj(A).characteristic_poly())
    c = _ints(Ft.order, (3, 3), rng)
    D = np.zeros((33, 33), dtype=np.int64)
    for k in range(11):
        D[3 * k : 3 * k + 3, 3 * k : 3 * k + 3] = c
    S = _invertible(fid, 33, 32)
    Sinv = np.asarray(np.linalg.inv(Fj(S)), dtype=np.int64)
    A = np.asarray(Fj(S) @ Fj(D) @ Fj(Sinv), dtype=np.int64)
    _same_poly(Ft(A).minimal_poly(), Fj(A).minimal_poly())


@pytest.mark.parametrize(["fid", "n"], [("GF256", 40), ("Goldilocks", 8)])
def test_char_and_min_poly_of_known_matrices(fid, n):
    """A = S C(f) S^-1, C the companion matrix of a random monic f: charpoly
    = minpoly = f; A = S diag(C(g), C(g)) S^-1: charpoly g^2, minpoly g.
    The checks are independent of the elimination (the device route for
    GF(2^8) at n = 40, the host loops for Goldilocks)."""
    Ft, _ = _fields(fid)
    rng = np.random.default_rng(33)

    def companion(coeffs_asc):
        k = len(coeffs_asc)
        C = np.zeros((k, k), dtype=object)
        C[1:, :-1] = np.eye(k - 1, dtype=np.int64)
        C[:, -1] = np.asarray(-Ft(coeffs_asc), dtype=object)
        return C

    S = Ft(_invertible(fid, n, 34))
    Sinv = np.linalg.inv(S)
    f = _ints(Ft.order, (n,), rng).tolist()
    A = S @ Ft(companion(f)) @ Sinv
    want = gt.Poly(Ft([1] + f[::-1]))
    assert A.characteristic_poly() == want and A.minimal_poly() == want
    g = _ints(Ft.order, (n // 2,), rng).tolist()
    D = np.zeros((n, n), dtype=object)
    D[: n // 2, : n // 2] = D[n // 2 :, n // 2 :] = companion(g)
    A = S @ Ft(D) @ Sinv
    gp = gt.Poly(Ft([1] + g[::-1]))
    assert A.characteristic_poly() == gp * gp and A.minimal_poly() == gp


# ----------------------------------------------------------------------
# Package boundary
# ----------------------------------------------------------------------

def test_linalg_leaves_jax_out():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import galois_tpu_torch as gt\n"
        "gt.set_default_device('cpu')\n"
        "F = gt.GF(7)\n"
        "A = F(np.arange(40 * 40).reshape(40, 40) % 7) + F.Identity(40)\n"
        "np.linalg.det(A), A.row_reduce(), A.characteristic_poly(), A.minimal_poly(), A.null_space()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'galois_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
