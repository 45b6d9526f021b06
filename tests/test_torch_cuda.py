"""The torch port's hand-written kernels on a CUDA card.

Each kernel is held against its plain torch version on the same inputs, on
the card; the tolerance is exact equality. These tests need a CUDA card and
skip without one. This file imports neither jax nor galois_tpu, so it runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import galois_tpu_torch as gt
from galois_tpu_torch.ops._elementwise import gf2m_multiply, gf2m_multiply_plain
from galois_tpu_torch.ops._linalg import balanced_planes_np
from galois_tpu_torch.ops._plane_matmul import (
    plane_matmul_data_left,
    plane_matmul_data_left_plain,
    plane_matmul_data_right,
    plane_matmul_data_right_plain,
)

P = 3 * 2**30 + 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(256, 512, 256, 2), (300, 520, 200, 3), (64, 4096, 64, 1)])
def test_plane_matmul_kernels_match_plain(cuda_device, shape):
    m, k, n, b = shape
    rng = np.random.default_rng(sum(shape))
    A = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (m, k)), P)).to(cuda_device)
    W = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (k, n)), P)).to(cuda_device)
    xr = torch.from_numpy(rng.integers(0, P, (b, k, n))).to(cuda_device)
    xl = torch.from_numpy(rng.integers(0, P, (b, m, k))).to(cuda_device)
    T = torch.from_numpy(rng.integers(0, P, (m, n))).to(cuda_device)
    xr[0, 0, :3] = torch.tensor([0, P // 2, P - 1])
    launches = plane_matmul_data_right.launches
    for tw in (None, T):
        got = plane_matmul_data_right(A, xr, P, twiddle=tw)
        torch.cuda.synchronize()
        assert torch.equal(got, plane_matmul_data_right_plain(A, xr, P, tw))
    assert plane_matmul_data_right.launches == launches + 2
    for tr in (False, True):
        got = plane_matmul_data_left(xl, W, P, transpose_out=tr)
        torch.cuda.synchronize()
        assert torch.equal(got, plane_matmul_data_left_plain(xl, W, P, tr))


@pytest.mark.parametrize("p", [7340033, 2**32 - 5])  # 3 and 5 balanced planes
def test_plane_matmul_kernels_other_plane_counts(cuda_device, p):
    rng = np.random.default_rng(p % 1000)
    A = torch.from_numpy(balanced_planes_np(rng.integers(0, p, (96, 80)), p)).to(cuda_device)
    x = torch.from_numpy(rng.integers(0, p, (2, 80, 72))).to(cuda_device)
    got = plane_matmul_data_right(A, x, p)
    torch.cuda.synchronize()
    assert torch.equal(got, plane_matmul_data_right_plain(A, x, p))


def test_plane_matmul_refuses_shapes_outside_the_gate(cuda_device):
    A = torch.zeros((4, 8, 32768), dtype=torch.int8, device=cuda_device)
    x = torch.zeros((1, 32768, 8), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        plane_matmul_data_right(A, x, P)


@pytest.mark.parametrize("m", [2, 8, 13, 16])
def test_gf2m_multiply_kernel_matches_plain(cuda_device, m):
    F = gt.GF(2**m)
    f = F._meta.irreducible_poly_int
    dt = F._meta.torch_dtype
    g = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randint(0, 2**m, (100_003,), generator=g, device=cuda_device).to(dt)
    b = torch.randint(0, 2**m, (100_003,), generator=g, device=cuda_device).to(dt)
    launches = gf2m_multiply.launches
    got = gf2m_multiply(a, b, m, f)
    torch.cuda.synchronize()
    assert gf2m_multiply.launches == launches + 1
    assert got.dtype == dt
    assert torch.equal(got, gf2m_multiply_plain(a, b, m, f))
    assert torch.equal(got.cpu(), gf2m_multiply_plain(a.cpu(), b.cpu(), m, f))


def test_ntt_on_cuda_matches_cpu(cuda_device):
    F = gt.GF(P)
    x = F.Random((3, 2**12), seed=4)
    X_cpu = np.fft.fft(x)
    before = (plane_matmul_data_right.launches, plane_matmul_data_left.launches)
    X_gpu = np.fft.fft(F(x._data, device=cuda_device))
    assert X_gpu.device.type == "cuda"
    assert (plane_matmul_data_right.launches, plane_matmul_data_left.launches) == (before[0] + 1, before[1] + 1)
    assert np.array_equal(np.asarray(X_gpu), np.asarray(X_cpu))
    assert torch.equal(np.fft.ifft(X_gpu)._data.cpu(), x._data)


def test_field_arithmetic_on_cuda_matches_cpu(cuda_device):
    for order in (2**8, 2**16, 257, P):
        F = gt.GF(order)
        a = F.Random(1000, seed=1)
        b = F.Random(1000, seed=2, low=1)
        ga, gb = F(a._data, device=cuda_device), F(b._data, device=cuda_device)
        for op in (lambda u, v: u * v, lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u / v):
            got = op(ga, gb)
            assert got.device.type == "cuda"
            assert np.array_equal(np.asarray(got), np.asarray(op(a, b)))
        assert np.array_equal(np.asarray(ga ** 5), np.asarray(a ** 5))
