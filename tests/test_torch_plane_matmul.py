"""Kernels K1 and K2 (the NTT's plane-matmul sides) of the torch port.

Their plain versions are held against the JAX Pallas kernels, run in
interpret mode at one TPU tile (256 x 512 x 256, batch 2), and against the
JAX package's ``_prime_matmul_planes``. Exact integer equality throughout.
The kernels themselves run only on a CUDA card; ``tests/test_torch_cuda.py``
compares them with their plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import galois_tpu_torch as gt
from galois_tpu.ops._linalg import _prime_matmul_planes as jax_prime_matmul_planes
from galois_tpu.ops._linalg import balanced_plane_count as jax_plane_count
from galois_tpu.ops._linalg import balanced_planes_np as jax_planes_np
from galois_tpu.ops._pallas._plane_matmul import (
    plane_matmul_data_left as jax_data_left,
    plane_matmul_data_right as jax_data_right,
)
from galois_tpu_torch.ops._linalg import _prime_matmul_planes, balanced_plane_count, balanced_planes_np
from galois_tpu_torch.ops._plane_matmul import (
    plane_matmul_data_left,
    plane_matmul_data_left_plain,
    plane_matmul_data_right,
    plane_matmul_data_right_plain,
    supports,
)

P = 3 * 2**30 + 1
M, K, N, B = 256, 512, 256, 2


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(5)
    return {
        "x_right": rng.integers(0, P, (B, K, N), dtype=np.int64),  # data on the right (K1)
        "x_left": rng.integers(0, P, (B, M, K), dtype=np.int64),  # data on the left (K2)
        "A": rng.integers(0, P, (M, K), dtype=np.int64),  # K1's table
        "W": rng.integers(0, P, (K, N), dtype=np.int64),  # K2's table
        "T": rng.integers(0, P, (M, N), dtype=np.int64),  # K1's twiddle
    }


def _u32(a):
    return jnp.asarray(a.astype(np.uint32))


@pytest.mark.parametrize("p", [257, 65537, 7340033, 2**31 - 1, P, 2**32 - 5])
def test_balanced_planes_match_jax(p):
    assert balanced_plane_count(p) == jax_plane_count(p)
    x = np.random.default_rng(p % 97).integers(0, p, 1000, dtype=np.int64)
    x[:3] = [0, p // 2, p - 1]
    assert np.array_equal(balanced_planes_np(x, p), jax_planes_np(x, p))


@pytest.mark.parametrize("twiddle", [False, True])
def test_data_right_plain_matches_pallas(operands, twiddle):
    o = operands
    Apl = balanced_planes_np(o["A"], P)
    want = np.asarray(
        jax_data_right(jnp.asarray(Apl), _u32(o["x_right"]), P, True, twiddle=_u32(o["T"]) if twiddle else None)
    ).astype(np.int64)
    got = plane_matmul_data_right_plain(
        torch.from_numpy(Apl), torch.from_numpy(o["x_right"]), P,
        torch.from_numpy(o["T"]) if twiddle else None,
    )
    assert got.shape == (B, M, N) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("transpose_out", [False, True])
def test_data_left_plain_matches_pallas(operands, transpose_out):
    o = operands
    Wpl = balanced_planes_np(o["W"], P)
    want = np.asarray(
        jax_data_left(_u32(o["x_left"]), jnp.asarray(Wpl), P, True, transpose_out=transpose_out)
    ).astype(np.int64)
    got = plane_matmul_data_left_plain(torch.from_numpy(o["x_left"]), torch.from_numpy(Wpl), P, transpose_out)
    assert got.shape == ((B, N, M) if transpose_out else (B, M, N))
    assert np.array_equal(got.numpy(), want)


def test_prime_matmul_planes_matches_jax(operands):
    o = operands
    xl, W = o["x_left"][0], o["W"]
    want = np.asarray(jax_prime_matmul_planes(_u32(xl), _u32(W), P, K)).astype(np.int64)
    got = _prime_matmul_planes(torch.from_numpy(xl), torch.from_numpy(W), P, K)
    assert np.array_equal(got.numpy(), want)
    # host matmul oracle on a slice, in exact Python ints
    ref = (xl[:4].astype(object) @ W[:, :3].astype(object)) % P
    assert np.array_equal(got.numpy()[:4, :3], ref.astype(np.int64))


def test_supports_gate():
    assert supports(P, 4096, 4096, 4096)
    assert supports(P, 300, 520, 200)  # ragged shapes are masked, not refused
    assert not supports(P, 64, 32768, 64)  # 4 * 32768 * 128^2 = 2^31: int32 overflow
    assert not supports(257, 16, 16, 16)  # |D_s| < p cannot hold for a small prime
    assert supports(7340033, 128, 128, 128)  # 3 planes


def test_wrappers_serve_cpu_with_plain_and_refuse_other_devices(operands):
    o = operands
    Apl = torch.from_numpy(balanced_planes_np(o["A"], P))
    Wpl = torch.from_numpy(balanced_planes_np(o["W"], P))
    xr = torch.from_numpy(o["x_right"][:, :, :64])
    xl = torch.from_numpy(o["x_left"][:, :64])
    n_right, n_left = plane_matmul_data_right.launches, plane_matmul_data_left.launches
    assert torch.equal(plane_matmul_data_right(Apl, xr, P), plane_matmul_data_right_plain(Apl, xr, P))
    assert torch.equal(
        plane_matmul_data_left(xl, Wpl, P, transpose_out=True),
        plane_matmul_data_left_plain(xl, Wpl, P, transpose_out=True),
    )
    assert (plane_matmul_data_right.launches, plane_matmul_data_left.launches) == (n_right, n_left)
    with pytest.raises(ValueError):
        plane_matmul_data_right(Apl.to("meta"), xr.to("meta"), P)
    with pytest.raises(ValueError):
        plane_matmul_data_left(xl.to("meta"), Wpl.to("meta"), P)


@pytest.mark.parametrize("p", [257, P])
def test_prime_matmul_matches_jax(p):
    """Both branches: one exact float64 matmul for small p, planes above."""
    from galois_tpu.fields._meta import FieldMeta
    from galois_tpu.ops._linalg import _prime_matmul as jax_prime_matmul
    from galois_tpu_torch.ops._linalg import _prime_matmul

    rng = np.random.default_rng(p % 1000)
    a = rng.integers(0, p, (3, 40, 96), dtype=np.int64)
    b = rng.integers(0, p, (96, 24), dtype=np.int64)
    dt = np.uint16 if p < 2**16 else np.uint32
    meta = FieldMeta(p, 1, 2 * p - 3, 3)
    want = np.asarray(jax_prime_matmul(jnp.asarray(a.astype(dt)), jnp.asarray(b.astype(dt)), p, 96, meta))
    got = _prime_matmul(torch.from_numpy(a), torch.from_numpy(b), p, 96)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
