"""The NTT slice of the torch port against the JAX package.

Inputs are made with numpy from a seed and given to both packages;
results must be equal as integers. The JAX side runs its default CPU path,
which ``tests/test_pallas.py`` pins equal to its Pallas side kernels.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.ops._ntt import MatmulFFTPlan as JaxMatmulFFTPlan
from galois_tpu.ops._ntt import _get_omega as jax_get_omega
from galois_tpu_torch.ops._ntt import FFTPlan, MatmulFFTPlan, _get_omega, _plan
from galois_tpu_torch.ops._plane_matmul import plane_matmul_data_left, plane_matmul_data_right

P = 3 * 2**30 + 1


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield

NTT_LUTS = [
    ([1, 2, 3, 4], 5, [0, 4, 3, 2]),
    ([1, 2, 3, 4], 13, [10, 8, 11, 1]),
    ([1, 2, 3, 4], 17, [10, 6, 15, 7]),
    ([1, 2, 3, 4], 3 * 256 + 1, [10, 643, 767, 122]),
]


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize(["x", "p", "X"], NTT_LUTS)
def test_ntt_intt_small(x, p, X):
    F = gt.GF(p)
    for form in (tuple(x), list(x), np.array(x), F(x)):
        got = gt.ntt(form) if isinstance(form, F) else gt.ntt(form, modulus=p)
        assert isinstance(got, F)
        _same(got, gj.ntt(x, modulus=p))
        assert np.array_equal(np.asarray(got, dtype=np.int64), X)
    _same(gt.intt(X, modulus=p), gj.intt(X, modulus=p))
    _same(gt.intt(X, modulus=p, scaled=False), gj.intt(X, modulus=p, scaled=False))
    assert np.array_equal(np.asarray(gt.intt(X, modulus=p), dtype=np.int64), x)


def test_ntt_default_modulus_and_errors():
    x = [1, 2, 3, 40]
    _same(gt.ntt(x), gj.ntt(x))
    with pytest.raises(ValueError):
        gt.ntt(gt.GF(2**8)([1, 2, 3, 4]))
    with pytest.raises(ValueError):
        gt.ntt([1, 2, 3, 4], size=3)
    with pytest.raises(ValueError):
        gt.ntt([1, 2, 3, 40], modulus=13)
    with pytest.raises(ValueError):
        gt.ntt([1, 2, 3, 4], modulus=3 * 256 + 2)


@pytest.mark.parametrize("shape", [(8,), (2, 8), (4, 2), (16, 4)])
def test_ntt_intt_shapes_match_jax(shape):
    """size defaults to len(x) and the transform runs along the trailing
    axis, as in the JAX package; batched transforms are np.fft.fft."""
    x = np.random.default_rng(len(shape)).integers(0, 17, shape)
    for kw in ({"modulus": 17}, {"modulus": 17, "size": 8}, {}):
        try:
            want = gj.ntt(x, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                gt.ntt(x, **kw)
            continue
        _same(gt.ntt(x, **kw), want)
        _same(gt.intt(np.asarray(want), **kw), gj.intt(np.asarray(want), **kw))
    Ft, Fj = gt.GF(17), gj.GF(17)
    _same(gt.ntt(Ft(x)), gj.ntt(Fj(x)))
    _same(gt.intt(Ft(x)), gj.intt(Fj(x)))


@pytest.mark.parametrize("N", [2**10, 2**16, 3 * 2**10])
def test_fft_batched_matches_jax(N):
    x = np.random.default_rng(N).integers(0, P, (3, N), dtype=np.int64)
    x[0, :3] = [0, 1, P - 1]
    Ft, Fj = gt.GF(P), gj.GF(P)
    Xt = np.fft.fft(Ft(x))
    _same(Xt, np.fft.fft(Fj(x)))
    _same(np.fft.fft(Ft(x), norm="forward"), np.fft.fft(Fj(x), norm="forward"))
    _same(np.fft.ifft(Xt), x.astype(np.uint32))
    _same(gt.intt(gt.ntt(Ft(x[1]))), x[1].astype(np.uint32))
    plan = _plan(Ft._meta, N, _get_omega(Ft, N), "jit-calculate", torch.device("cpu"))
    assert isinstance(plan, MatmulFFTPlan) and plan.kernel_sides


def test_fft_2_18_matches_jax_default_path():
    N = 2**18  # n1 = n2 = 512
    x = np.random.default_rng(18).integers(0, P, N, dtype=np.int64)
    n_right, n_left = plane_matmul_data_right.launches, plane_matmul_data_left.launches
    Xt = gt.ntt(gt.GF(P)(x))
    _same(Xt, gj.ntt(gj.GF(P)(x)))
    # on CPU the kernel wrappers serve their plain versions: no launches
    assert (plane_matmul_data_right.launches, plane_matmul_data_left.launches) == (n_right, n_left)


@pytest.mark.parametrize(["N", "n1"], [(2**10, 32), (2**18, 512), (3 * 2**10, 48)])
def test_plan_tables_match_jax_and_load_tables(N, n1):
    Ft, Fj = gt.GF(P), gj.GF(P)
    omega = _get_omega(Ft, N)
    assert omega == jax_get_omega(Fj, N)
    jplan = JaxMatmulFFTPlan(Fj._meta, N, omega, "jit-calculate", n1)
    tplan = MatmulFFTPlan(Ft._meta, N, omega, "jit-calculate", n1, "cpu")
    for name in ("W1", "T", "W2"):
        mine, ref = getattr(tplan, name), getattr(jplan, name)
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref), name
    x = torch.from_numpy(np.random.default_rng(n1).integers(0, P, (2, N), dtype=np.int64))
    own = tplan.transform(x)
    tplan.load_tables(jplan.W1, jplan.T, jplan.W2)
    assert torch.equal(tplan.transform(x), own)
    with pytest.raises(ValueError):
        tplan.load_tables(jplan.W2, jplan.T, jplan.W1[:1])


@pytest.mark.parametrize(["q", "N"], [(257, 64), (257, 256), (2**8, 15), (2**8, 255), (P, 3), (2, 1)])
def test_fft_other_fields_and_plans_match_jax(q, N):
    x = np.random.default_rng(q + N).integers(0, q, (2, N), dtype=np.int64)
    Ft, Fj = gt.GF(q), gj.GF(q)
    X = np.fft.fft(Ft(x))
    _same(X, np.fft.fft(Fj(x)))
    _same(np.fft.ifft(X), np.fft.ifft(np.fft.fft(Fj(x))))
    plan = _plan(Ft._meta, N, _get_omega(Ft, N), "jit-calculate", torch.device("cpu"))
    # GF(257) at N = 256 takes the 4-step plan outside the kernels' gate
    assert isinstance(plan, MatmulFFTPlan if (q, N) == (257, 256) else FFTPlan)
    if isinstance(plan, MatmulFFTPlan):
        assert not plan.kernel_sides


def test_fft_pad_and_trim_match_jax():
    x = np.random.default_rng(0).integers(0, P, 100, dtype=np.int64)
    Ft, Fj = gt.GF(P), gj.GF(P)
    _same(np.fft.fft(Ft(x), n=128), np.fft.fft(Fj(x), n=128))
    _same(np.fft.ifft(Ft(x), n=64), np.fft.ifft(Fj(x), n=64))
