"""The limb-field matmul and NTT and the recursive 6-step plan of the torch
port against the JAX package.

``ops/_limb_matmul.py`` (Goldilocks' 7-bit planes, the generic biased byte
planes for BLS12-381's scalar field), the public ``@`` over both, the limb
branch of ``MatmulFFTPlan`` (factored tables, ``np.fft.fft``/``ifft``) and
the recursive sub-plans of int and limb storage. The same inputs, made
with numpy from a seed, go through ``galois_tpu`` and ``galois_tpu_torch``
where the JAX side compiles in seconds, and through Python-int arithmetic
(the JAX package's host field) where it would take minutes; the tolerance
is exact integer equality.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.ops import _limb_matmul, _ntt
from galois_tpu_torch.ops._ntt import FFTPlan, MatmulFFTPlan, _get_omega, _plan

P = 3 * 2**30 + 1
GOLDILOCKS = 2**64 - 2**32 + 1
BLS_R = 52435875175126190479447740508185965837690552500527637822603658699938581184513
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _rand(p, shape, seed):
    rng = np.random.default_rng(seed)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        out[idx] = int.from_bytes(rng.bytes(40), "little") % p
    return out


def _host_matmul(p, A, B):
    """Python-int (A @ B) mod p of 2-D object arrays."""
    out = np.empty((A.shape[0], B.shape[1]), dtype=object)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            out[i, j] = sum(int(A[i, k]) * int(B[k, j]) for k in range(A.shape[1])) % p
    return out


def _ints(x):
    return np.asarray(x, dtype=object)


def test_goldilocks_matmul_matches_jax():
    from galois_tpu.ops._limb_matmul import goldilocks_matmul as jax_goldilocks_matmul

    Ft, Fj = gt.GF(GOLDILOCKS), gj.GF(GOLDILOCKS)
    A, B = _rand(GOLDILOCKS, (5, 7), 0), _rand(GOLDILOCKS, (7, 6), 1)
    A[0, :3] = [0, 1, GOLDILOCKS - 1]
    want = jax_goldilocks_matmul(Fj._meta, Fj(A)._data, Fj(B)._data)
    got = _limb_matmul.goldilocks_matmul(Ft._meta, Ft(A)._data, Ft(B)._data)
    assert got.dtype == torch.uint16
    _same(got, want)
    _same((Ft(A) @ Ft(B))._data, want)


def test_generic_limb_matmul_matches_jax():
    from galois_tpu.ops._limb_matmul import generic_limb_matmul as jax_generic_limb_matmul

    Ft, Fj = gt.GF(BLS_R), gj.GF(BLS_R)
    A, B = _rand(BLS_R, (3, 5), 2), _rand(BLS_R, (5, 4), 3)
    A[0, :3] = [0, 1, BLS_R - 1]
    want = jax_generic_limb_matmul(Fj._meta, Fj(A)._data, Fj(B)._data)
    _same(_limb_matmul.generic_limb_matmul(Ft._meta, Ft(A)._data, Ft(B)._data), want)


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_limb_matmul_max_values_past_one_block(p):
    """Every digit at its largest (p - 1) at a K past one block (Goldilocks'
    13315, the generic path's 2048): (p - 1)^2 = 1, so every entry is K mod p.
    A random product at that K against Python ints."""
    F = gt.GF(p)
    kblk = _limb_matmul._MAX_BLOCK_K if p == GOLDILOCKS else _limb_matmul._kblk_for(2 * F._meta.storage_width)
    K = kblk + 5
    full = np.full((3, K), p - 1, dtype=object)
    got = _ints(F(full) @ F(full.T.copy()))
    assert got.shape == (3, 3) and all(int(v) == K % p for v in got.reshape(-1))
    A, B = _rand(p, (2, K), 4), _rand(p, (K, 3), 5)
    assert np.array_equal(_ints(F(A) @ F(B)), _host_matmul(p, A, B))


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_limb_matmul_batched_sides_and_vectors(p):
    F = gt.GF(p)
    A, Ab = _rand(p, (3, 4), 6), _rand(p, (2, 3, 4), 7)
    B, Bb = _rand(p, (4, 2), 8), _rand(p, (2, 4, 2), 9)
    cases = [(A, Bb), (Ab, B), (Ab, Bb), (Ab[:1], Bb)]  # b batched, a batched, both, broadcast
    for a, b in cases:
        got = _ints(F(a) @ F(b))
        shape = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        aa, bb = np.broadcast_to(a, shape + a.shape[-2:]), np.broadcast_to(b, shape + b.shape[-2:])
        for t in np.ndindex(*shape):
            assert np.array_equal(got[t], _host_matmul(p, aa[t], bb[t]))
    v = _rand(p, (4,), 10)
    assert np.array_equal(_ints(F(A) @ F(v)), _host_matmul(p, A, v[:, None])[:, 0])
    assert np.array_equal(_ints(F(v) @ F(B)), _host_matmul(p, v[None, :], B)[0])
    with pytest.raises(ValueError):
        F(A) @ F(A)


def test_chunked_output_columns_match_one_chunk(monkeypatch):
    """Output chunks of 32 columns and a ragged last one, on both paths."""
    for p in (GOLDILOCKS, BLS_R):
        F = gt.GF(p)
        A, B = F.Random((3, 9), seed=11), F.Random((9, 70), seed=12)
        want = _ints(A @ B)
        monkeypatch.setattr(_limb_matmul, "_CHUNK_BYTES", 1)
        assert np.array_equal(_ints(A @ B), want)
        monkeypatch.undo()


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_limb_plan_tables_match_jax(p):
    """N = 128 (8 x 16): the ladders the plan keeps on the host are the JAX
    plan's, and the tables gathered from them equal the JAX plan's."""
    from galois_tpu.ops._ntt import _get_omega as jax_get_omega
    from galois_tpu.ops._ntt import _plan as jax_plan

    Ft, Fj = gt.GF(p), gj.GF(p)
    N = 128
    omega = _get_omega(Ft, N)
    assert omega == jax_get_omega(Fj, N)
    tplan, jplan = _plan(Ft._meta, N, omega, "jit-calculate", CPU), jax_plan(Fj._meta, N, omega, "jit-calculate")
    assert isinstance(tplan, MatmulFFTPlan) and tplan.factored and (tplan.n1, tplan.n2) == (jplan.n1, jplan.n2)
    for name in ("lad_hi", "lad_lo", "lad_w2"):
        assert np.array_equal(getattr(tplan, name), np.asarray(getattr(jplan, name))), name
    W1, T, W2 = jplan._host_tables()
    for mine, ref in ((tplan.w1, W1), (tplan.t, T), (tplan.w2, W2)):
        _same(mine, ref)


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_small_limb_transforms_match_jax(p):
    """N <= 64 goes through FFTPlan on planar storage, as in the JAX package."""
    Ft, Fj = gt.GF(p), gj.GF(p)
    x = [1, 2, 3, 4]
    assert isinstance(_plan(Ft._meta, 4, _get_omega(Ft, 4), "jit-calculate", CPU), FFTPlan)
    X = np.fft.fft(Ft(x))
    _same(X, np.fft.fft(Fj(x)))
    _same(np.fft.ifft(X), Fj(x))


def _direct_bins(p, xs, N, bins, omega):
    out = []
    for k in bins:
        w = pow(omega, k, p)
        acc, wk = 0, 1
        for v in xs:
            acc = (acc + int(v) * wk) % p
            wk = wk * w % p
        out.append(acc)
    return out


def test_bls_round_trip_at_1024():
    F = gt.GF(BLS_R)
    N = 1024
    x = F.Random((2, N), seed=13)
    X = np.fft.fft(x)
    assert isinstance(_plan(F._meta, N, _get_omega(F, N), "jit-calculate", CPU), MatmulFFTPlan)
    assert X._data.dtype == torch.uint16 and X.shape == (2, N)
    assert torch.equal(np.fft.ifft(X)._data, x._data)
    bins = [0, 1, 77, N - 1]
    xs = _ints(x[1])
    assert [int(v) for v in _ints(X[1])[bins]] == _direct_bins(BLS_R, xs, N, bins, _get_omega(F, N))


def test_goldilocks_fft_at_4096_matches_jax():
    Ft, Fj = gt.GF(GOLDILOCKS), gj.GF(GOLDILOCKS)
    x = Fj.Random(2**12, seed=14)
    X = np.fft.fft(Ft(np.asarray(x)))
    _same(X, np.fft.fft(x))
    _same(np.fft.ifft(X), x)


def test_wide_limb_multiply_in_chunks(monkeypatch):
    """The twiddle table and the 1/N scaling of a BLS transform in chunks of
    a few rows give the results of one chunk."""
    F = gt.GF(BLS_R)
    x = F.Random(256, seed=15)
    want = np.fft.ifft(x)._data
    monkeypatch.setattr(_ntt, "_MUL_BYTES", 96 * 16 * 16 * 3)
    _plan.cache_clear()
    try:
        assert torch.equal(np.fft.ifft(x)._data, want)
    finally:
        _plan.cache_clear()


def test_recursive_plan_helpers_match_jax():
    from galois_tpu.ops import _ntt as jax_ntt

    assert _ntt._RECURSE_ABOVE == jax_ntt._RECURSE_ABOVE
    for K in (2, 97, 128, 4096, 8192, 16384, 3 * 2**13, 2**26, 4099 * 6):
        assert _ntt._balanced_split(K) == jax_ntt._balanced_split(K)
        assert _ntt._largest_divisor_le(K, 4096) == jax_ntt._largest_divisor_le(K, 4096)
    # 2^26 has no two-factor split <= 4096: 4096 x 16384, the second a 128 x 128 sub-plan
    assert _ntt._matmul_split(2**26) is None and _ntt._largest_divisor_le(2**26, 4096) == 4096
    assert _ntt._balanced_split(2**14) == 128


def test_recursive_plan_matches_jax():
    """N = 2^16 with n1 = 8: n2 = 8192 is a 64 x 128 sub-plan. Its tables are
    the JAX plan's, and it transforms as the direct 256 x 256 plan does (held
    against the JAX package in tests/test_torch_ntt.py)."""
    Ft, Fj = gt.GF(P), gj.GF(P)
    N = 2**16
    omega = _get_omega(Ft, N)
    from galois_tpu.ops._ntt import MatmulFFTPlan as JaxMatmulFFTPlan

    jplan = JaxMatmulFFTPlan(Fj._meta, N, omega, "jit-calculate", 8)
    tplan = MatmulFFTPlan(Ft._meta, N, omega, "jit-calculate", 8, CPU)
    assert tplan.sub1 is None and tplan.sub2 is not None and tplan.W2 is None
    assert (tplan.sub2.n1, tplan.sub2.n2) == (jplan.sub2.n1, jplan.sub2.n2) == (64, 128)
    for mine, ref in ((tplan, jplan), (tplan.sub2, jplan.sub2)):
        for name in ("W1", "T", "W2"):
            t, j = getattr(mine, name), getattr(ref, name)
            assert (t is None and j is None) or np.array_equal(t, j), name
    assert tplan.kernel1 and not tplan.kernel2 and tplan.sub2.kernel_sides
    x = Ft.Random((2, N), seed=16)
    assert torch.equal(tplan.transform(x._data), np.fft.fft(x)._data)


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_recursive_limb_plan(p):
    """A limb plan with a sub-plan side (2 x 8192, the 8192 a 64 x 128
    factored sub-plan) transforms as the direct 128 x 128 plan does."""
    F = gt.GF(p)
    N = 2**14
    omega = _get_omega(F, N)
    plan = MatmulFFTPlan(F._meta, N, omega, "jit-calculate", 2, CPU)
    assert plan.sub2 is not None and plan.sub2.factored and plan.w2 is None and plan.lad_w2 is None
    x = F.Random(N, seed=17)
    direct = _plan(F._meta, N, omega, "jit-calculate", CPU)
    assert direct.sub1 is None and direct.sub2 is None
    X = plan.transform(x._data)
    assert torch.equal(X, direct.transform(x._data))
    assert int(_ints(F._view(X))[5]) == _direct_bins(p, _ints(x), N, [5], omega)[0]
