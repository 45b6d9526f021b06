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
import galois_tpu as gj
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
    kmajor_planes,
    plane_digits_plain,
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


# ----------------------------------------------------------------------
# The Hopper kernels' layouts: the prologue's K-major digit planes and the
# tables' K-major copies (K padded to 16), on the CPU through the plain
# versions. Exact equality throughout.
# ----------------------------------------------------------------------

def _jax_extract_planes(x: np.ndarray, p: int) -> np.ndarray:
    """The TPU kernels' own digit split, ``_extract_planes``, run in a
    Pallas kernel in interpret mode: (R, K) residues -> (n, R, K) int8."""
    import jax
    from jax.experimental import pallas as pl
    from galois_tpu.ops._pallas._plane_matmul import _extract_planes

    n = jax_plane_count(p)

    def kernel(x_ref, o_ref):
        for i, d in enumerate(_extract_planes(x_ref[...], p, n)):
            o_ref[i] = d

    out = jax.ShapeDtypeStruct((n,) + x.shape, jnp.int8)
    return np.asarray(pl.pallas_call(kernel, out_shape=out, interpret=True)(_u32(x)))


def _pad_k(planes: np.ndarray) -> np.ndarray:
    K = planes.shape[-1]
    pad = [(0, 0)] * (planes.ndim - 1) + [(0, -K % 16)]
    return np.pad(planes, pad)


@pytest.mark.parametrize("p", [7340033, P, 2**32 - 5])  # 3, 4 and 5 planes
@pytest.mark.parametrize("cols", [False, True])
def test_plane_digits_plain_matches_jax(p, cols):
    """The prologue's plain version: (B, rows, K) data, or (B, K, rows) for
    K1, -> (B, n, rows, Kp) K-major planes, zero padded from a ragged K = 37
    to 48; against the JAX package's balanced_planes_np and, up to four
    planes, the JAX kernels' own _extract_planes. The digits spell the
    symmetric residue exactly.

    Known deviation of the reference: at five planes (p within 0.4% of
    2^32) _extract_planes works in int32, so for |x'| near p/2 its fourth
    step wraps and the fifth digit comes out 0 where the exact split has 1:
    the value is off by 2^32. The port follows balanced_planes_np."""
    B, R, K = 2, 24, 37
    rng = np.random.default_rng(p % 1000)
    x = rng.integers(0, p, (B, R, K), dtype=np.int64)
    x.reshape(-1)[:4] = [0, p // 2, p // 2 + 1, p - 1]
    data = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)) if cols else x)
    got = plane_digits_plain(data, p, cols)
    n = jax_plane_count(p)
    assert got.shape == (B, n, R, 48) and got.dtype == torch.int8
    assert np.array_equal(got.numpy(), _pad_k(jax_planes_np(x, p).transpose(1, 0, 2, 3)))
    if n <= 4:
        want = _pad_k(np.stack([_jax_extract_planes(x[b], p) for b in range(B)]))
        assert np.array_equal(got.numpy(), want)
    assert not got[..., K:].any()
    digits = got.numpy()[..., :K].astype(np.int64)
    value = sum(digits[:, i] * 256**i for i in range(n))
    assert np.array_equal(value, np.where(x > p // 2, x - p, x))


@pytest.mark.parametrize("k_axis", [1, 2])
def test_kmajor_planes_roundtrip(operands, k_axis):
    raw = balanced_planes_np(operands["A"][:40, :37], P)  # (n, 40, 37): K = 37 on axis 2, or 40 on axis 1
    km = kmajor_planes(torch.from_numpy(raw), k_axis)
    K = raw.shape[k_axis]
    rows_k = raw if k_axis == 2 else raw.transpose(0, 2, 1)
    assert km.K == K and km.planes.shape == (4, rows_k.shape[1], -(-K // 16) * 16)
    assert np.array_equal(km.planes.numpy(), _pad_k(rows_k))
    assert torch.equal(km.raw(k_axis), torch.from_numpy(raw))
    assert kmajor_planes(km, k_axis) is km


def test_wrappers_take_kmajor_tables(operands):
    """The CPU wrappers (plain versions) give the same with raw and K-major
    tables, also at a K that is no multiple of 16."""
    o = operands
    A, W = o["A"][:, :100], o["W"][:100]
    Apl, Wpl = torch.from_numpy(balanced_planes_np(A, P)), torch.from_numpy(balanced_planes_np(W, P))
    xr = torch.from_numpy(o["x_right"][:, :100, :40])
    xl = torch.from_numpy(o["x_left"][:, :40, :100])
    T = torch.from_numpy(o["T"][:, :40])
    assert torch.equal(
        plane_matmul_data_right(kmajor_planes(Apl, 2), xr, P, T), plane_matmul_data_right_plain(Apl, xr, P, T)
    )
    assert torch.equal(
        plane_matmul_data_left(xl, kmajor_planes(Wpl, 1), P, True), plane_matmul_data_left_plain(xl, Wpl, P, True)
    )


def _old_gate(p, M, K, N):
    """supports() as the mma.sync kernel had it."""
    n = jax_plane_count(p)
    return p < 2**32 and n in (3, 4, 5) and n * K * 128**2 < min(2**31, p) and min(M, K, N) >= 1


def test_supports_unchanged_on_a_grid():
    for p in (257, 65537, 7340033, 2**31 - 1, P, 2**32 - 5, 2**32 + 15):
        for M in (1, 100, 128, 4096):
            for K in (1, 16, 37, 148, 149, 1000, 4096, 26214, 26215, 32767, 32768):
                for N in (1, 48, 100, 4096):
                    assert supports(p, M, K, N) == _old_gate(p, M, K, N), (p, M, K, N)


@pytest.mark.parametrize(["p", "N"], [(P, 2**10), (7340033, 7 * 2**8)])
def test_plan_kmajor_tables_and_transform_match_jax(p, N):
    """load_tables keeps W1 as (n, k1, n1) and W2 as (n, k2, n2) K-major
    planes, K padded to 16 (n2 = 56 for GF(7340033) at N = 1792), and the
    plan's transform still equals the JAX plan's."""
    from galois_tpu.ops._ntt import MatmulFFTPlan as JaxMatmulFFTPlan
    from galois_tpu.ops._ntt import _get_omega as jax_get_omega
    from galois_tpu_torch.ops._ntt import MatmulFFTPlan, _get_omega, _matmul_split

    Ft, Fj = gt.GF(p), gj.GF(p)
    omega, n1 = _get_omega(Ft, N), _matmul_split(N)
    assert omega == jax_get_omega(Fj, N)
    jplan = JaxMatmulFFTPlan(Fj._meta, N, omega, "jit-calculate", n1)
    tplan = MatmulFFTPlan(Ft._meta, N, omega, "jit-calculate", n1, "cpu")
    assert tplan.kernel_sides
    w1, w2 = tplan.w1_planes, tplan.w2_planes
    assert np.array_equal(w1.planes.numpy(), _pad_k(jax_planes_np(jplan.W1.astype(np.int64), p)))
    assert np.array_equal(w2.planes.numpy(), _pad_k(jax_planes_np(jplan.W2.astype(np.int64), p).transpose(0, 2, 1)))
    assert (w1.K, w2.K) == (tplan.n1, tplan.n2)
    x = np.random.default_rng(N).integers(0, p, (2, N), dtype=np.int64)
    want = np.asarray(jplan.transform(jnp.asarray(x.astype(jplan.W1.dtype)))).astype(np.int64)
    assert np.array_equal(tplan.transform(torch.from_numpy(x)).numpy().astype(np.int64), want)
