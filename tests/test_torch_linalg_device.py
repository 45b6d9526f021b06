"""Linear algebra over GF(q) of the torch port against the JAX package: the
device route of the elimination (A.size > 4096) and its functions called
directly.

Row reduction on both sides of the cutoff: A.size 4096 (64 x 64, the host
elimination) and 4160 (64 x 65, the device loop); inv, solve, det, PLU and
rank at 65 x 65. The JAX package compiles its device functions once per
shape, so its device routes run for a few fields at shared shapes; for the
others the port's device route is held against the JAX package's host
elimination, which computes the same unique answers without a compile. The
port's device functions are also called directly against the JAX ones,
with columns that have no pivot, including Goldilocks' planar limbs. The
same inputs, made with numpy from a seed, go through both packages; the
tolerance is exact integer equality.
"""

import numpy as np
import pytest
import torch

from galois_tpu.ops import _linalg as jl
from galois_tpu_torch.ops import _kernels, _linalg
from tests.test_torch_linalg import (  # noqa: F401  (the module fixture is used by name)
    _deficient,
    _fields,
    _ints,
    _invertible,
    _on_cpu_and_restore_modes,
    _pair,
    _raises_alike,
    _same,
)


# ----------------------------------------------------------------------
# The device route (A.size > 4096) at the public boundary
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fid", ["GF2", "GF16", "GF256", "GF7", "M31", "Goldilocks"])
def test_row_reduce_on_both_sides_of_the_cutoff(fid):
    """64 x 64 (4096 elements: the host elimination in both packages) and
    64 x 65 (4160: the port's device loop) of one draw with columns that
    hold no pivot; the JAX package's host elimination gives the unique RREF
    of the device route."""
    Ft, Fj = _fields(fid)
    A = _deficient(fid, (64, 65), 17)
    A[:, 60] = 0
    _same(Ft(A[:, :64]).row_reduce(), Fj(A[:, :64]).row_reduce())
    assert np.linalg.matrix_rank(Ft(A[:, :64])) == np.linalg.matrix_rank(Fj(A[:, :64]))
    R, rank, _ = jl._host_row_reduce(Fj, A, 65)
    _same(Ft(A).row_reduce(), R)
    # eye="right" and a dtype other than the default: the caller's dtype is kept
    dt = Ft.dtypes[-1]
    Rr = Ft(A, dtype=dt).row_reduce(eye="right")
    _same(Rr, Fj(A).row_reduce(eye="right"))
    assert Rr.dtype == dt


@pytest.mark.parametrize("fid", ["GF2", "GF16", "GF256", "GF7", "M31"])
def test_inv_solve_det_plu_on_the_device(fid):
    """65 x 65 (the device loops; at 4096 elements and below the host
    elimination of the tests above): inv and solve against one host
    elimination of [B | I | b] in the JAX package, PLU against its host PLU,
    det against the product of that U's diagonal, and the rank."""
    Ft, Fj = _fields(fid)
    B = _invertible(fid, 65, 18)
    b = _ints(Ft.order, (65,), np.random.default_rng(19))
    aug = np.concatenate([B, np.eye(65, dtype=np.int64), b[:, None]], axis=1).astype(object)
    R = jl._host_row_reduce(Fj, aug, 65)[0]
    dt = Ft.dtypes[-1]  # a dtype other than the default, kept by every result
    Bt = Ft(B, dtype=dt)
    Binv = np.linalg.inv(Bt)
    _same(Binv, R[:, 65:130])
    _same(np.linalg.solve(Bt, Ft(b)), R[:, 130])
    P, L, U, swaps = jl._plu(Fj, Fj(B))
    PLU = Bt.plu_decompose()
    for got, want in zip(PLU, (P, L, U)):
        _same(got, want)
    Pd = Fj(np.asarray(U, dtype=object).diagonal().tolist()).prod()
    d = np.linalg.det(Bt)
    _same(d, -Pd if swaps % 2 else Pd)
    assert all(X.dtype == dt for X in (Binv, d, *PLU))
    S = _deficient(fid, (65, 65), 20)
    St = Ft(S)
    assert np.linalg.matrix_rank(St) == jl._host_row_reduce(Fj, S, 65)[1]
    _same(np.linalg.det(St), Fj(0))
    _raises_alike(lambda: np.linalg.inv(St), lambda: np.linalg.inv(Fj(S[:8, :8])))
    B[0, 0], B[1, 0] = 0, 1  # the first pivot needs a row exchange: no LU
    _raises_alike(lambda: Ft(B).lu_decompose(), lambda: Fj(B[:8, :8]).lu_decompose())


@pytest.mark.parametrize("fid", ["GF243", "GF256-lookup"])
def test_device_route_matches_jax_device_route(fid):
    """Both packages' device loops at 64 x 65 and 65 x 65, and the spaces of
    the 64 x 65 matrix (the null space reduces [A^T | I], 65 x 129) (for
    GF(3^5) the host elimination in Python ints is the slow side)."""
    A = _deficient(fid, (64, 65), 21)
    At, Aj = _pair(fid, A)
    _same(At.row_reduce(), Aj.row_reduce())
    assert np.linalg.matrix_rank(At) == np.linalg.matrix_rank(Aj)
    Bt, Bj = _pair(fid, _invertible(fid, 65, 22))
    _same(np.linalg.inv(Bt), np.linalg.inv(Bj))
    _same(np.linalg.det(Bt), np.linalg.det(Bj))
    for got, want in zip(Bt.plu_decompose(), Bj.plu_decompose()):
        _same(got, want)
    _same(At.row_space(), Aj.row_space())
    _same(At.null_space(), Aj.null_space())


# ----------------------------------------------------------------------
# The device functions, called directly
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fid", ["GF2", "GF256", "GF7", "Goldilocks"])
def test_device_functions_match_jax(fid):
    """``_row_reduce_data`` (more columns than rows: the early-exit check),
    ``_plu_data`` and ``_det_data`` against the JAX functions on matrices
    with columns that hold no pivot; one shape a function, so the JAX
    package compiles each once. Goldilocks is planar (4, M, N) storage; its
    reciprocal is a Fermat ladder, slow in the plain version, so it runs at
    n = 6, and its device inverse ([B | I] reduced) is held here too."""
    Ft, Fj = _fields(fid)
    meta_t, meta_j, mode = Ft._meta, Fj._meta, Ft._mode
    n = 6 if fid == "Goldilocks" else 12
    for A in (_deficient(fid, (n, n + 2), 23), _ints(Ft.order, (n, n + 2), np.random.default_rng(24))):
        R, rank = _linalg._row_reduce_data(meta_t, mode, Ft(A)._data, n + 2)
        Rj, rank_j = jl._row_reduce_data(meta_j, mode, Fj(A)._data, n + 2)
        _same(Ft._view(R), Fj._view(Rj))
        assert int(rank) == int(rank_j)
    for A in (_deficient(fid, (n, n), 25), _invertible(fid, n, 26)):
        lu, perm, swaps = _linalg._plu_data(meta_t, mode, Ft(A)._data)
        lu_j, perm_j, swaps_j = jl._plu_data(meta_j, mode, Fj(A)._data)
        _same(Ft._view(lu), Fj._view(lu_j))
        assert perm.tolist() == np.asarray(perm_j).tolist() and int(swaps) == int(swaps_j)
        _same(Ft._view(_linalg._det_data(meta_t, mode, Ft(A)._data)), Fj._view(jl._det_data(meta_j, mode, Fj(A)._data)))
    if fid == "Goldilocks":
        B = _invertible(fid, n, 26)
        R, _ = _linalg._row_reduce_data(meta_t, mode, torch.cat([Ft(B)._data, Ft.Identity(n)._data], dim=-1), n)
        _same(Ft._view(R[..., n:]), np.linalg.inv(Fj(B)))


@pytest.mark.parametrize("fid", ["GF2", "GF7"])
def test_row_reduce_stops_at_full_rank(fid):
    """A 12 x 64 matrix whose last row is 0 left of column c = 31 and 1 at c:
    the rank reaches 12 at column 31, so ``_row_reduce_data`` reads its pivot
    count at columns 11 and 27 and stops at the check after 31, well before
    column 63. The RREF, unique, is the JAX package's host elimination's."""
    Ft, Fj = _fields(fid)
    rng = np.random.default_rng(28)
    while True:
        A = _ints(Ft.order, (12, 64), rng)
        A[11, :31], A[11, 31] = 0, 1
        R, rank, pivots = jl._host_row_reduce(Fj, A.astype(object), 64)
        if rank == 12 and pivots[-1] == 31:
            break
    assert _linalg._EXIT_CHECK_EVERY < 64 - 31
    out, got_rank = _linalg._row_reduce_data(Ft._meta, Ft._mode, Ft(A)._data, 64)
    _same(Ft._view(out), R)
    assert int(got_rank) == 12


def test_device_functions_leave_their_input_unchanged():
    for fid, shape in (("GF256", (65, 66)), ("GF7", (65, 66)), ("Goldilocks", (6, 7))):
        Ft, _ = _fields(fid)
        A = Ft(_deficient(fid, shape, 27))
        before = A._data.clone()
        _linalg._row_reduce_data(Ft._meta, Ft._mode, A._data, shape[1])
        _linalg._plu_data(Ft._meta, Ft._mode, A._data)
        if A.size > 4096:
            A.row_reduce()
            np.linalg.det(A[:, :65])
        assert torch.equal(A._data, before)
    Ft, _ = _fields("GF7")
    A = Ft(_ints(7, (40, 40), np.random.default_rng(28)))
    before = A._data.clone()
    A.characteristic_poly(), A.minimal_poly()
    assert torch.equal(A._data, before)


def test_row_reduce_launches_two_products_a_column_and_one_reciprocal(monkeypatch):
    """GF(2^8): each column step of [A | I] calls K8 twice (the rows scaled
    by the pivot, and the rank-1 update with its operands as broadcast
    views, not materialized copies) and K8-A never; the call ends with one
    K8-A reciprocal of every row's leading element, a tree product of the
    pivots and one more product."""
    Ft, _ = _fields("GF256")
    n = 70
    calls = {"scale": 0, "update": 0, "other": 0, "rec": 0}
    swar, power = _kernels.gf2m_multiply_swar, _kernels.gf2m_power

    def mul(a, b, m, f):
        if a.shape == (n, 2 * n) and b.dim() == 0:
            calls["scale"] += 1
        elif a.shape == (n, 1) and b.shape == (1, 2 * n) and b.stride(1) == 1:
            calls["update"] += 1  # the column of factors and a row view
        else:
            calls["other"] += 1
        return swar(a, b, m, f)

    def rec(a, e, m, f, nbits=0):
        calls["rec"] += int(e is None)
        return power(a, e, m, f, nbits)

    monkeypatch.setattr(_kernels, "gf2m_multiply_swar", mul)
    monkeypatch.setattr(_kernels, "gf2m_power", rec)
    A = Ft(_invertible("GF256", n, 29))
    Ainv = np.linalg.inv(A)
    assert (calls["scale"], calls["update"], calls["rec"]) == (n, n, 1)
    assert calls["other"] == n.bit_length() + 1  # the tree over n + 1 pivots, the normalization
    assert np.array_equal(np.asarray(A @ Ainv), np.eye(n, dtype=np.uint8))
