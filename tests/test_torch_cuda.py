"""The torch port's hand-written kernels on a CUDA card.

Each kernel is held against its plain torch version on the same inputs, on
the card; the tolerance is exact equality. These tests need a CUDA card and
skip without one. This file imports neither jax nor galois_tpu, so it runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

import galois_tpu_torch as gt
from galois_tpu_torch.ops._bm_scan import berlekamp_massey_scan, berlekamp_massey_scan_plain, bm_scan_supports
from galois_tpu_torch.ops._elementwise import (
    device_probe,
    device_probe_plain,
    gf2m_multiply,
    gf2m_multiply_plain,
    gf2m_multiply_swar,
    gf2m_multiply_swar_plain,
    gf2m_power,
    gf2m_power_plain,
    goldilocks_multiply,
    goldilocks_multiply_plain,
    m31_multiply,
    m31_multiply_plain,
)
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops import _charpoly, _linalg
from galois_tpu_torch.ops._limb_binary import DENSE_MODULI, EDGE_MODULI
from galois_tpu_torch.ops._limb_matmul import int8_matmul
from galois_tpu_torch.ops._linalg import balanced_planes_np
from galois_tpu_torch.ops._lookup import (
    SMEM_MAX_ORDER,
    lookup_divide,
    lookup_divide_plain,
    lookup_log,
    lookup_log_plain,
    lookup_multiply,
    lookup_multiply_plain,
    lookup_placement,
    lookup_reciprocal,
    lookup_reciprocal_plain,
    pack_tables,
)
from galois_tpu_torch.ops._plane_matmul import (
    kmajor_planes,
    plane_digits,
    plane_digits_plain,
    plane_matmul_data_left,
    plane_matmul_data_left_plain,
    plane_matmul_data_right,
    plane_matmul_data_right_plain,
)

P = 3 * 2**30 + 1
M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1
BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# The kernel's tiles are 128 rows by 48 columns (4 planes) and 64-deep K
# stages of K padded to 16: ragged M, N and K, K % 16 != 0, batch 1 and 3.
PLANE_SHAPES = [
    (256, 512, 256, 2), (300, 520, 200, 3), (64, 4096, 64, 1), (130, 100, 50, 1), (257, 1000, 97, 3),
    (128, 4096, 96, 2), (1, 1, 1, 1), (1000, 37, 1000, 1),
]


@pytest.mark.parametrize("shape", PLANE_SHAPES)
def test_plane_matmul_kernels_match_plain(cuda_device, shape):
    m, k, n, b = shape
    rng = np.random.default_rng(sum(shape))
    A = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (m, k)), P)).to(cuda_device)
    W = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (k, n)), P)).to(cuda_device)
    xr = torch.from_numpy(rng.integers(0, P, (b, k, n))).to(cuda_device)
    xl = torch.from_numpy(rng.integers(0, P, (b, m, k))).to(cuda_device)
    T = torch.from_numpy(rng.integers(0, P, (m, n))).to(cuda_device)
    edges = torch.tensor([0, P // 2, P // 2 + 1, P - 1])
    xr.view(-1)[:4] = edges[: min(4, xr.numel())]
    xl.view(-1)[:4] = edges[: min(4, xl.numel())]
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
    # both sides at ragged shapes inside the gate (K < 149 for 3 planes)
    m, k, n, b = (200, 120, 100, 3) if p == 7340033 else (260, 1000, 130, 1)
    A = torch.from_numpy(balanced_planes_np(rng.integers(0, p, (m, k)), p)).to(cuda_device)
    W = torch.from_numpy(balanced_planes_np(rng.integers(0, p, (k, n)), p)).to(cuda_device)
    T = torch.from_numpy(rng.integers(0, p, (m, n))).to(cuda_device)
    xr = torch.from_numpy(rng.integers(0, p, (b, k, n))).to(cuda_device)
    xl = torch.from_numpy(rng.integers(0, p, (b, m, k))).to(cuda_device)
    xr[0, 0, :4] = xl[0, 0, :4] = torch.tensor([0, p // 2, p // 2 + 1, p - 1])
    assert torch.equal(plane_matmul_data_right(A, xr, p, twiddle=T), plane_matmul_data_right_plain(A, xr, p, T))
    for tr in (False, True):
        assert torch.equal(plane_matmul_data_left(xl, W, p, tr), plane_matmul_data_left_plain(xl, W, p, tr))


@pytest.mark.parametrize("p", [7340033, P, 2**32 - 5])  # 3, 4 and 5 planes
@pytest.mark.parametrize("shape", [(2, 37, 300), (3, 128, 65), (1, 1000, 4096)])
def test_plane_digits_kernel_matches_plain(cuda_device, p, shape):
    """The prologue: (B, rows, K) or (B, K, rows) int64 -> (B, n, rows, Kp)
    int8, K-major, zero padded to a multiple of 16, edge values included."""
    rng = np.random.default_rng(p % 1000 + sum(shape))
    x = torch.from_numpy(rng.integers(0, p, shape)).to(cuda_device)
    x.view(-1)[:4] = torch.tensor([0, p // 2, p // 2 + 1, p - 1])
    for cols in (False, True):
        got = plane_digits(x, p, cols)
        torch.cuda.synchronize()
        assert torch.equal(got, plane_digits_plain(x, p, cols))


def test_plane_matmul_kmajor_tables_match_raw(cuda_device):
    """Tables given K-major (as MatmulFFTPlan keeps them) take no repack and
    give what raw tables (repacked by the wrapper) give."""
    rng = np.random.default_rng(9)
    m, k, n, b = 200, 520, 150, 2
    A = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (m, k)), P)).to(cuda_device)
    W = torch.from_numpy(balanced_planes_np(rng.integers(0, P, (k, n)), P)).to(cuda_device)
    Ak, Wk = kmajor_planes(A, 2), kmajor_planes(W, 1)
    assert Ak.planes.shape == (4, m, 528) and Wk.planes.shape == (4, n, 528)
    xr = torch.from_numpy(rng.integers(0, P, (b, k, n))).to(cuda_device)
    xl = torch.from_numpy(rng.integers(0, P, (b, m, k))).to(cuda_device)
    assert torch.equal(plane_matmul_data_right(Ak, xr, P), plane_matmul_data_right(A, xr, P))
    assert torch.equal(plane_matmul_data_right(Ak, xr, P), plane_matmul_data_right_plain(Ak, xr, P))
    assert torch.equal(plane_matmul_data_left(xl, Wk, P, True), plane_matmul_data_left(xl, W, P, True))
    assert torch.equal(plane_matmul_data_left(xl, Wk, P), plane_matmul_data_left_plain(xl, W, P))


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


@pytest.mark.parametrize("m", range(2, 9))
def test_gf2m_multiply_swar_kernel_matches_plain(cuda_device, m):
    """K8 at 2^20 (the 16-byte path), a ragged length (its byte tail) and an
    offset view (every chunk on byte loads)."""
    F = gt.GF(2**m)
    f = F._meta.irreducible_poly_int
    g = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randint(0, 2**m, (2**20 + 3,), generator=g, device=cuda_device).to(torch.uint8)
    b = torch.randint(0, 2**m, (2**20 + 3,), generator=g, device=cuda_device).to(torch.uint8)
    for x, y in ((a[: 2**20], b[: 2**20]), (a[:100_003], b[:100_003]), (a[3:], b[:-3]), (a[1:18], b[2:19])):
        launches = gf2m_multiply_swar.launches
        got = gf2m_multiply_swar(x, y, m, f)
        torch.cuda.synchronize()
        assert gf2m_multiply_swar.launches == launches + 1
        assert got.dtype == torch.uint8 and got.shape == x.shape
        assert torch.equal(got, gf2m_multiply_swar_plain(x, y, m, f))
        assert torch.equal(got, gf2m_multiply_plain(x, y, m, f))
    if m == 8:  # another irreducible f, and a broadcast operand
        got = gf2m_multiply_swar(a[:1000].reshape(10, 100), b[:100], 8, 0x11B)
        assert torch.equal(got, gf2m_multiply_swar_plain(a[:1000].reshape(10, 100), b[:100], 8, 0x11B))
    with pytest.raises(TypeError):
        gf2m_multiply_swar(a.to(torch.int64), b.to(torch.int64), m, f)


@pytest.mark.parametrize("m", range(2, 17))
def test_gf2m_power_kernel_matches_plain(cuda_device, m):
    """K8-A: reciprocals and exponent tensors at a ragged length, on its
    16-byte path, one byte off alignment, with a broadcast exponent column,
    a broadcast 0-D base, a 3-D broadcast (materialized), and 0^0."""
    F = gt.GF(2**m)
    f = F._meta.irreducible_poly_int
    dt = F._meta.torch_dtype
    g = torch.Generator(device=cuda_device).manual_seed(m)
    n = 2**16 + 5
    a = torch.randint(0, 2**m, (n,), generator=g, device=cuda_device).to(dt)
    a[:3] = torch.tensor([0, 1, 2**m - 1])
    e = torch.randint(0, 2**40, (n,), generator=g, device=cuda_device)
    e[:4] = torch.tensor([0, 0, 2**m - 1, -1])
    zeros = torch.zeros(100, dtype=dt, device=cuda_device)
    cases = [
        (a, None, 0), (a[: 2**16], None, 0), (a[1:], None, 0),
        (a, e, 40), (a[: 2**16], e[: 2**16], 64), (a[1:], e[:-1], 64), (a[1:], e[:-1], m),
        (a[:1000].reshape(10, 100), e[:10].reshape(10, 1), 64),  # exponent column, read with stride 0
        (a[5], e[:1000].reshape(40, 25), 40),  # 0-D base, as the erasure locator's g
        (a[:200].reshape(4, 1, 50), e[:3].reshape(1, 3, 1), 40),  # three axes, read by stride
        (a[:8].reshape(2, 1, 4, 1), e[:15].reshape(1, 3, 1, 5), 40),  # four axes: materialized
        (zeros, torch.zeros(100, dtype=torch.int64, device=cuda_device), 8),  # 0^0 = 1
    ]
    for x, y, nbits in cases:
        launches = gf2m_power.launches
        got = gf2m_power(x, y, m, f, nbits)
        torch.cuda.synchronize()
        assert gf2m_power.launches == launches + 1
        assert got.dtype == dt and torch.equal(got, gf2m_power_plain(x, y, m, f, nbits))
    assert torch.equal(gf2m_power(zeros, torch.zeros(100, dtype=torch.int64, device=cuda_device), m, f, 8), torch.ones_like(zeros))
    with pytest.raises(TypeError):
        gf2m_power(a.to(torch.int32), None, m, f)


# K8's layouts, (a, b) as slices of two random buffers: whole tensors, the
# RS decoder's broadcasts (read by stride), an inner axis below 16 (element
# by element), a transposed operand, four axes (materialized), one element.
K8_LAYOUTS = {
    "contiguous": lambda a, b: (a[:100_003], b[:100_003]),
    "view one element in": lambda a, b: (a[1:50_001], b[3:50_003]),
    "one element": lambda a, b: (a[7:8], b[:4099]),
    "0-D": lambda a, b: (a[7], b[:4099].reshape(1, 4099)),
    "outer product (B, 1, 33) x (B, 32, 1)": lambda a, b: (a[: 999 * 33].reshape(999, 1, 33), b[: 999 * 32].reshape(999, 32, 1)),
    "outer product swapped": lambda a, b: (b[: 999 * 32].reshape(999, 32, 1), a[: 999 * 33].reshape(999, 1, 33)),
    "row broadcast (B, 255) x (1, 255)": lambda a, b: (a[: 500 * 255].reshape(500, 255), b[:255].reshape(1, 255)),
    "column broadcast (B, 33) x (B, 1)": lambda a, b: (a[: 999 * 33].reshape(999, 33), b[:999].reshape(999, 1)),
    "derivative (B, 32) x (1, 32)": lambda a, b: (a[: 999 * 32].reshape(999, 32), b[:32].reshape(1, 32)),
    "inner axis of 5": lambda a, b: (a[: 999 * 5].reshape(999, 1, 5), b[: 999 * 3].reshape(999, 3, 1)),
    "transposed": lambda a, b: (a[: 300 * 200].reshape(300, 200).t(), b[: 200 * 300].reshape(200, 300)),
    "four axes": lambda a, b: (a[: 6 * 16].reshape(6, 1, 16, 1)[:, :, ::2], b[: 7 * 9].reshape(1, 7, 1, 9)),
}


@pytest.mark.parametrize("layout", list(K8_LAYOUTS))
@pytest.mark.parametrize("m", [2, 5, 8])
def test_gf2m_multiply_swar_kernel_layouts(cuda_device, m, layout):
    """K8 by the field's byte rows on every layout kind: one launch, equal
    to its plain version (the SWAR form) and to the ladder."""
    f = gt.GF(2**m)._meta.irreducible_poly_int
    g = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randint(0, 2**m, (2**17,), generator=g, device=cuda_device).to(torch.uint8)
    b = torch.randint(0, 2**m, (2**17,), generator=g, device=cuda_device).to(torch.uint8)
    a[::97] = 0
    x, y = K8_LAYOUTS[layout](a, b)
    launches = gf2m_multiply_swar.launches
    got = gf2m_multiply_swar(x, y, m, f)
    torch.cuda.synchronize()
    assert gf2m_multiply_swar.launches == launches + 1
    assert got.shape == torch.broadcast_shapes(x.shape, y.shape)
    assert torch.equal(got, gf2m_multiply_swar_plain(x, y, m, f))
    assert torch.equal(got, gf2m_multiply_plain(x, y, m, f))


@pytest.mark.parametrize("m", [3, 8, 9, 14, 15, 16])
def test_gf2m_power_kernel_placements(cuda_device, m):
    """K8-A on each table placement (byte rows; LOG and EXP staged; LOG
    staged and EXP through L1): every element (or a sample above 2^12) by
    the reciprocal pass and by the strided pass, exponents 0, 1, q - 1, q,
    2^63 - 1 and -1 with nbits 0, m and 64, and 0^e."""
    F = gt.GF(2**m)
    f, dt, q = F._meta.irreducible_poly_int, F._meta.torch_dtype, 2**m
    g = torch.Generator(device=cuda_device).manual_seed(m)
    every = torch.arange(q, device=cuda_device) if q <= 4096 else torch.randint(0, q, (4096,), generator=g, device=cuda_device)
    every = every.to(dt)
    edges = torch.tensor([0, 1, q - 1, q, 2**63 - 1, -1], device=cuda_device)
    cases = [(every, None, 0), (every.repeat(2)[::2], None, 0), (every.reshape(2, -1).t(), None, 0)]
    cases += [(every[:, None], edges[None, :], nb) for nb in (0, m, 64)]
    cases += [(torch.zeros(6, dtype=dt, device=cuda_device), edges, 64)]
    for x, y, nb in cases:
        got = gf2m_power(x, y, m, f, nb)
        torch.cuda.synchronize()
        assert got.dtype == dt and torch.equal(got, gf2m_power_plain(x, y, m, f, nb))
    assert int(gf2m_power(torch.zeros(1, dtype=dt, device=cuda_device), None, m, f)) == 0  # 1 / 0 is 0, as the chain


@pytest.mark.parametrize("m", [2, 4, 8, 9, 12, 16])
@pytest.mark.parametrize("d", [2, 3, 5, 17, 33, 65])
def test_bm_scan_kernel_matches_plain(cuda_device, m, d):
    """K8-B at (4099, d - 1): erasure offsets 0, d - 1, beyond and random;
    rows whose discrepancies are all 0 or start with a run of 0s. Outside
    the kernel's domain (d = 65 above m = 8) the wrapper raises."""
    F = gt.GF(2**m)
    ops = get_ops(F._meta, F._mode)
    g = torch.Generator(device=cuda_device).manual_seed(10 * m + d)
    rows = 4099
    S = torch.randint(0, 2**m, (rows, d - 1), generator=g, device=cuda_device).to(F._meta.torch_dtype)
    S[1] = 0
    S[2, : (d - 1) // 2] = 0
    S[3] = 2**m - 1
    u = torch.randint(0, d + 2, (rows,), generator=g, device=cuda_device)
    u[:5] = torch.tensor([0, 0, 0, d - 1, d + 4])
    if not bm_scan_supports(m, d):
        with pytest.raises(ValueError):
            berlekamp_massey_scan(ops, S, u, d)
        return
    for uu in (u, torch.zeros_like(u)):
        launches = berlekamp_massey_scan.launches
        C, L = berlekamp_massey_scan(ops, S, uu, d)
        torch.cuda.synchronize()
        assert berlekamp_massey_scan.launches == launches + 1
        Cp, Lp = berlekamp_massey_scan_plain(ops, S, uu, d)
        assert C.shape == (rows, d) and C.dtype == S.dtype and torch.equal(C, Cp) and torch.equal(L, Lp)


def test_bch_511_493_decode_on_cuda_runs_the_scan_kernel_once(cuda_device):
    """BCH(511,493) (GF(2^9), d = 5) on the card: one K8-B launch per decode
    and no plain scan; the results equal the CPU's."""
    bch = gt.BCH(511, 493)
    rng = np.random.default_rng(9)
    msg = rng.integers(0, 2, (300, bch.k))
    cw = np.asarray(bch.encode(bch.field.from_numpy(msg, device="cpu"))).astype(np.int64)
    for i in range(300):
        cw[i, rng.choice(bch.n, size=i % 5, replace=False)] ^= 1
    launches = berlekamp_massey_scan.launches
    got, e_got = bch.decode(bch.field.from_numpy(cw, device=cuda_device), errors=True)
    torch.cuda.synchronize()
    assert berlekamp_massey_scan.launches == launches + 1
    want, e_want = bch.decode(bch.field.from_numpy(cw, device="cpu"), errors=True)
    assert np.array_equal(np.asarray(got), np.asarray(want)) and np.array_equal(e_got, e_want)


def test_rs_decode_on_cuda_runs_the_scan_kernel_once(cuda_device):
    """RS(255,223) on the card: one K8-B launch per decode, K8-A for Forney's
    reciprocal (and the erasure locator's powers), and 4 K8 launches (6 with
    erasures); the results equal the CPU's."""
    rs = gt.ReedSolomon(255, 223)
    rng = np.random.default_rng(6)
    msg = rng.integers(0, 256, (300, rs.k))
    cw = np.asarray(rs.encode(rs.field.from_numpy(msg, device="cpu"))).astype(np.int64)
    for i in range(300):
        pos = rng.choice(rs.n, size=i % 20, replace=False)
        cw[i, pos] ^= rng.integers(1, 256, pos.size)
    era = np.zeros(cw.shape, dtype=bool)
    era[::4, 5:9] = True
    for kw, k8, powers in (({}, 4, 1), ({"erasures": era}, 6, 2)):
        counts = [f.launches for f in (berlekamp_massey_scan, gf2m_power, gf2m_multiply_swar)]
        got, e_got = rs.decode(rs.field.from_numpy(cw, device=cuda_device), errors=True, **kw)
        torch.cuda.synchronize()
        delta = [f.launches - c for f, c in zip((berlekamp_massey_scan, gf2m_power, gf2m_multiply_swar), counts)]
        assert delta == [1, powers, k8]
        want, e_want = rs.decode(rs.field.from_numpy(cw, device="cpu"), errors=True, **kw)
        assert np.array_equal(np.asarray(got), np.asarray(want)) and np.array_equal(e_got, e_want)


def test_codes_on_cuda_match_cpu(cuda_device):
    """A small RS(255,223) and BCH(31,21) decode on the card (K8, the bit-plane
    matmuls) equals the same decode on the CPU, errors and erasures."""
    rng = np.random.default_rng(5)
    for code in (gt.ReedSolomon(255, 223), gt.BCH(31, 21)):
        q = code.field.order
        msg = rng.integers(0, q, (64, code.k))
        cw = np.asarray(code.encode(code.field.from_numpy(msg, device="cpu"))).astype(np.int64)
        for i in range(64):
            pos = rng.choice(code.n, size=i % (code.t + 2), replace=False)
            cw[i, pos] ^= rng.integers(1, q, pos.size)
        era = np.zeros(cw.shape, dtype=bool)
        era[::3, :2] = True
        launches = (gf2m_multiply_swar.launches, gf2m_multiply.launches)
        for kw in ({}, {"erasures": era}):
            got, e_got = code.decode(code.field.from_numpy(cw, device=cuda_device), errors=True, **kw)
            want, e_want = code.decode(code.field.from_numpy(cw, device="cpu"), errors=True, **kw)
            assert got.device.type == "cuda" and np.array_equal(np.asarray(got), np.asarray(want))
            assert np.array_equal(e_got, e_want)
        assert gf2m_multiply_swar.launches > launches[0]  # GF(2^8) and GF(2^5) products
        ok = np.array([i % (code.t + 2) <= code.t for i in range(64)])
        got = code.decode(code.field.from_numpy(cw, device=cuda_device))
        assert np.array_equal(np.asarray(got)[ok], msg[ok])


def test_ntt_on_cuda_matches_cpu(cuda_device):
    F = gt.GF(P)
    x = F.Random((3, 2**12), seed=4, device="cpu")
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
        a = F.Random(1000, seed=1, device="cpu")
        b = F.Random(1000, seed=2, low=1, device="cpu")
        ga, gb = F(a._data, device=cuda_device), F(b._data, device=cuda_device)
        for op in (lambda u, v: u * v, lambda u, v: u + v, lambda u, v: u - v, lambda u, v: u / v):
            got = op(ga, gb)
            assert got.device.type == "cuda"
            assert np.array_equal(np.asarray(got), np.asarray(op(a, b)))
        assert np.array_equal(np.asarray(ga ** 5), np.asarray(a ** 5))


@pytest.mark.parametrize(
    ["q", "n"],
    [
        (2**8, 100_003),  # uint8 storage, tables in shared memory
        (3**5, 4097),  # uint8, odd characteristic
        (2**10, 1_000_003),  # int64, shared memory
        (2**14, 65_539),  # int64, the largest 'shared' order (64 KB for K3/K4, above the 48 KB default)
        (2**16, 100_003),  # int64, 'log-shared' (128 KB of LOG or INV in shared memory)
        (2**20, 30_001),  # int64, 'global': the largest tables (12 MB)
        (2**8, 1),
    ],
)
def test_lookup_kernels_match_plain(cuda_device, q, n):
    F = gt.GF(q)
    ops = get_ops(F._meta, "jit-lookup")
    exp_t, log_t = (torch.from_numpy(t).to(cuda_device) for t in (ops.EXP, ops.LOG))
    dt = F._meta.torch_dtype
    g = torch.Generator(device=cuda_device).manual_seed(q + n)
    a = torch.randint(0, q, (n,), generator=g, device=cuda_device).to(dt)
    b = torch.randint(0, q, (n,), generator=g, device=cuda_device).to(dt)
    a[:: 7] = 0  # zeros on each side and on both
    b[:: 5] = 0
    before = [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)]
    cases = [
        (lookup_multiply(a, b, exp_t, log_t, q), lookup_multiply_plain(a, b, exp_t, log_t, q)),
        (lookup_divide(a, b, exp_t, log_t, q), lookup_divide_plain(a, b, exp_t, log_t, q)),
        (lookup_reciprocal(a, exp_t, log_t, q), lookup_reciprocal_plain(a, exp_t, log_t, q)),
        (lookup_log(a, log_t, q), lookup_log_plain(a, log_t, q)),
    ]
    torch.cuda.synchronize()
    assert [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)] == [
        x + 1 for x in before
    ]
    for got, want in cases:
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert cases[3][0].dtype == torch.int64
    assert (q <= SMEM_MAX_ORDER) == (q in (2**8, 3**5, 2**10, 2**14))


def test_lookup_kernels_broadcast_and_refuse_bad_operands(cuda_device):
    F = gt.GF(2**8)
    ops = get_ops(F._meta, "jit-lookup")
    exp_t, log_t = (torch.from_numpy(t).to(cuda_device) for t in (ops.EXP, ops.LOG))
    col = torch.arange(256, dtype=torch.uint8, device=cuda_device).reshape(256, 1)
    row = torch.arange(256, dtype=torch.uint8, device=cuda_device).reshape(1, 256)
    got = lookup_multiply(col, row, exp_t, log_t, 256)
    assert got.shape == (256, 256)
    assert torch.equal(got, lookup_multiply_plain(col, row, exp_t, log_t, 256))
    with pytest.raises(TypeError):
        lookup_multiply(col, row.to(torch.int64), exp_t, log_t, 256)
    with pytest.raises(ValueError):
        lookup_multiply(col, row, exp_t[:-1], log_t, 256)
    with pytest.raises(ValueError):
        lookup_multiply(col, row.cpu(), exp_t, log_t, 256)


def _lookup_setup(q, device):
    F = gt.GF(q)
    ops = get_ops(F._meta, "jit-lookup")
    exp_t, log_t = (torch.from_numpy(t).to(device) for t in (ops.EXP, ops.LOG))
    return exp_t, log_t, pack_tables(exp_t, log_t, q, F._meta.torch_dtype), F._meta.torch_dtype


def _k3_k4_exact(a, b, exp_t, log_t, q, packed):
    """K3 and K4 (one launch each) against their plain versions."""
    before = lookup_multiply.launches, lookup_divide.launches
    got = lookup_multiply(a, b, exp_t, log_t, q, packed), lookup_divide(a, b, exp_t, log_t, q, packed)
    want = lookup_multiply_plain(a, b, exp_t, log_t, q), lookup_divide_plain(a, b, exp_t, log_t, q)
    torch.cuda.synchronize()
    assert (lookup_multiply.launches, lookup_divide.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("q", [2**8, 3**5])
def test_lookup_k3_k4_every_pair(cuda_device, q):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    a, b = (v.reshape(-1).to(dt) for v in torch.meshgrid(
        torch.arange(q, device=cuda_device), torch.arange(q, device=cuda_device), indexing="ij"))
    _k3_k4_exact(a, b, exp_t, log_t, q, packed)
    _k3_k4_exact(a, b, exp_t, log_t, q, None)  # packed by the wrapper


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 4099, 100_003])
@pytest.mark.parametrize("q", [2**8, 2**10, 2**14, 2**16, 2**20])
def test_lookup_k3_k4_placements_ragged(cuda_device, q, n):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    places = {2**8: "bytes", 2**10: "shared", 2**14: "shared", 2**16: "log-shared", 2**20: "global"}
    assert lookup_placement(q, dt) == places[q]
    g = torch.Generator(device=cuda_device).manual_seed(q + n)
    a = torch.randint(0, q, (n,), generator=g, device=cuda_device).to(dt)
    b = torch.randint(0, q, (n,), generator=g, device=cuda_device).to(dt)
    a[::7] = 0  # zeros on each side and on both
    b[::5] = 0
    b[1::11] = q - 1
    _k3_k4_exact(a, b, exp_t, log_t, q, packed)


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("q", [2**8, 2**10, 2**16])
def test_lookup_k3_k4_unaligned_views(cuda_device, q, side):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(q)
    base = torch.randint(0, q, (2, 5000), generator=g, device=cuda_device).to(dt)
    base[:, ::13] = 0
    for off in range(1, 16):
        view = base[0, off : off + 4096]
        other = base[1, :4096]
        a, b = (view, other) if side == "a" else (other, view)
        _k3_k4_exact(a, b, exp_t, log_t, q, packed)


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16, 2**20])
def test_lookup_k3_k4_one_element_and_broadcast_operands(cuda_device, q):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(q)
    x = torch.randint(0, q, (10_007,), generator=g, device=cuda_device).to(dt)
    x[::9] = 0
    for v in (0, 1, 3, q - 1):
        for shape in ((), (1, 1)):
            one = torch.full(shape, v, dtype=dt, device=cuda_device)
            _k3_k4_exact(one, x, exp_t, log_t, q, packed)
            _k3_k4_exact(x, one, exp_t, log_t, q, packed)
            _k3_k4_exact(one, x[1:], exp_t, log_t, q, packed)  # the streamed operand off alignment
    col, row = x[:300].reshape(300, 1), x[300:700].reshape(1, 400)
    _k3_k4_exact(col, row, exp_t, log_t, q, packed)  # a broadcast that is materialized
    _k3_k4_exact(x[:6].reshape(2, 3).t(), x[6:12].reshape(3, 2), exp_t, log_t, q, packed)  # a transposed view
    assert lookup_multiply(x[:0], x[:0], exp_t, log_t, q, packed).shape == (0,)


def _k5_k6_exact(a, exp_t, log_t, q, packed):
    """K5 and K6 (one launch each) against their plain versions."""
    before = lookup_reciprocal.launches, lookup_log.launches
    got = lookup_reciprocal(a, exp_t, log_t, q, packed), lookup_log(a, log_t, q, packed)
    want = lookup_reciprocal_plain(a, exp_t, log_t, q), lookup_log_plain(a, log_t, q)
    torch.cuda.synchronize()
    assert (lookup_reciprocal.launches, lookup_log.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


K5_K6_ORDERS = [2**8, 3**5, 2**10, 2**14, 2**16, 2**20]


@pytest.mark.parametrize("q", K5_K6_ORDERS)
def test_lookup_k5_k6_every_element(cuda_device, q):
    """Every element, 0 included (K5 gives EXP[q-1] = 1 there, K6 LOG[0] =
    0), by each placement: a uint8 field also in int64 storage ('shared')."""
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    every = torch.arange(q, device=cuda_device).to(dt)
    _k5_k6_exact(every, exp_t, log_t, q, packed)
    _k5_k6_exact(every, exp_t, log_t, q, None)  # packed by the wrapper
    if dt == torch.uint8:
        assert lookup_placement(q, torch.int64) == "shared"
        _k5_k6_exact(every.to(torch.int64), exp_t, log_t, q, pack_tables(exp_t, log_t, q, torch.int64))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 4099, 100_003])
@pytest.mark.parametrize("q", K5_K6_ORDERS)
def test_lookup_k5_k6_placements_ragged(cuda_device, q, n):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    places = {2**8: "bytes", 3**5: "bytes", 2**10: "shared", 2**14: "shared", 2**16: "log-shared", 2**20: "global"}
    assert lookup_placement(q, dt) == places[q]
    g = torch.Generator(device=cuda_device).manual_seed(q + n)
    a = torch.randint(0, q, (n,), generator=g, device=cuda_device).to(dt)
    a[::7] = 0
    a[3::11] = q - 1
    _k5_k6_exact(a, exp_t, log_t, q, packed)


@pytest.mark.parametrize("q", K5_K6_ORDERS)
def test_lookup_k5_k6_unaligned_views(cuda_device, q):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(q)
    base = torch.randint(0, q, (5000,), generator=g, device=cuda_device).to(dt)
    base[::13] = 0
    for off in range(1, 16):
        _k5_k6_exact(base[off : off + 4099], exp_t, log_t, q, packed)
        _k5_k6_exact(base[off:], exp_t, log_t, q, packed)


@pytest.mark.parametrize("q", K5_K6_ORDERS)
def test_lookup_k5_k6_one_element_and_other_shapes(cuda_device, q):
    exp_t, log_t, packed, dt = _lookup_setup(q, cuda_device)
    for v in (0, 1, 3, q - 1):
        for shape in ((), (1,), (1, 1)):
            _k5_k6_exact(torch.full(shape, v, dtype=dt, device=cuda_device), exp_t, log_t, q, packed)
    x = (torch.arange(300, device=cuda_device) % q).to(dt).reshape(6, 50)
    _k5_k6_exact(x, exp_t, log_t, q, packed)
    _k5_k6_exact(x.t(), exp_t, log_t, q, packed)  # a transposed view, made contiguous by the wrapper
    before = lookup_reciprocal.launches, lookup_log.launches
    assert lookup_reciprocal(x[:0], exp_t, log_t, q, packed).shape == (0, 50)
    assert lookup_log(x[:0], log_t, q, packed).shape == (0, 50)
    assert (lookup_reciprocal.launches, lookup_log.launches) == before  # nothing to launch


def test_lookup_k5_k6_refuse_a_table_of_another_layout(cuda_device):
    exp_t, log_t, packed, dt = _lookup_setup(2**10, cuda_device)
    a = torch.arange(1, 100, device=cuda_device)
    for wrong in (packed[:-8], packed.to(torch.int32), pack_tables(exp_t, log_t, 2**10, torch.int64).cpu()):
        with pytest.raises(ValueError):
            lookup_reciprocal(a, exp_t, log_t, 2**10, wrong)
        with pytest.raises(ValueError):
            lookup_log(a, log_t, 2**10, wrong)


def test_lookup_mode_on_cuda_matches_cpu(cuda_device):
    for q, mode in ((2**8, "jit-lookup"), (2**16, "jit-lookup"), (3**5, "jit-lookup"), (3**5, "jit-calculate")):
        F = gt.GF(q, compile=mode)
        try:
            a = F.Random(5000, seed=1, device="cpu")
            b = F.Random(5000, seed=2, low=1, device="cpu")
            ga, gb = F(a._data, device=cuda_device), F(b._data, device=cuda_device)
            for op in (
                lambda u, v: u * v,
                lambda u, v: u / v,
                lambda u, v: u + v,
                lambda u, v: u - v,
                lambda u, v: np.reciprocal(v),
                lambda u, v: v ** np.arange(5000),
                lambda u, v: v**-3,
            ):
                got = op(ga, gb)
                assert got.device.type == "cuda"
                assert np.array_equal(np.asarray(got), np.asarray(op(a, b)))
            if mode == "jit-lookup":
                assert np.array_equal(gb.log(), b.log())
                assert np.array_equal(gb.log(int(F.primitive_element ** 7)), b.log(int(F.primitive_element ** 7)))
        finally:
            F.compile("auto")


def test_device_probe_kernel_matches_plain(cuda_device):
    x = torch.arange(8 * 1024, dtype=torch.int32, device=cuda_device).reshape(8, 1024)
    launches = device_probe.launches
    got = device_probe(x)
    torch.cuda.synchronize()
    assert device_probe.launches == launches + 1
    assert torch.equal(got, device_probe_plain(x))


@pytest.mark.parametrize("n", [1_000_003, 2**20, 1, 7])
def test_m31_multiply_kernel_matches_plain(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    a = torch.randint(0, M31, (n,), generator=g, device=cuda_device)
    b = torch.randint(0, M31, (n,), generator=g, device=cuda_device)
    edges = torch.tensor([0, 1, M31 - 1, M31 - 1, 2**16, 2**30], device=cuda_device)
    a[: min(n, 6)] = edges[: min(n, 6)]
    b[: min(n, 6)] = edges.flip(0)[: min(n, 6)]
    launches = m31_multiply.launches
    got = m31_multiply(a, b)
    torch.cuda.synchronize()
    assert m31_multiply.launches == launches + 1
    assert got.dtype == torch.int64 and torch.equal(got, m31_multiply_plain(a, b))
    if n > 1:  # an odd offset takes the kernel's scalar loop
        assert torch.equal(m31_multiply(a[1:], b[1:]), m31_multiply_plain(a[1:], b[1:]))


def _limbs(values, device):
    v = torch.tensor([int(x) - 2**64 if x >= 2**63 else int(x) for x in values], dtype=torch.int64, device=device)
    return torch.stack([(v >> (16 * k)) & 0xFFFF for k in range(4)]).to(torch.uint16)


@pytest.mark.parametrize("n", [2**20, 1_000_003, 8, 3])
def test_goldilocks_multiply_kernel_matches_plain(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    # random limbs: values anywhere in [0, 2^64), non-canonical ones included
    a = torch.randint(0, 2**16, (4, n), generator=g, device=cuda_device).to(torch.uint16)
    b = torch.randint(0, 2**16, (4, n), generator=g, device=cuda_device).to(torch.uint16)
    edges = [0, 1, GOLDILOCKS - 1, 2**32 - 1, 2**32, 2**64 - 1, GOLDILOCKS, GOLDILOCKS + 5]
    m = min(n, len(edges))
    a[:, :m] = _limbs(edges[:m], cuda_device)
    b[:, :m] = _limbs(edges[::-1][:m], cuda_device)
    launches = goldilocks_multiply.launches
    got = goldilocks_multiply(a, b)
    torch.cuda.synchronize()
    assert goldilocks_multiply.launches == launches + 1
    assert got.dtype == torch.uint16 and torch.equal(got, goldilocks_multiply_plain(a, b))
    assert torch.equal(got.cpu(), goldilocks_multiply_plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize("shape", [(16, 4096), (3, 5, 8192), (5, 100), (7, 4099)])
def test_prime_multiply_kernels_take_a_period(cuda_device, shape):
    """Horner's inner step: (k, N) against (1, N) passes N as the period
    (or, below 4096 elements, materializes the broadcast)."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    row = (1,) + shape[1:]
    a = torch.randint(0, M31, shape, generator=g, device=cuda_device)
    x = torch.randint(0, M31, row, generator=g, device=cuda_device)
    assert torch.equal(m31_multiply(a, x), m31_multiply_plain(a, x))
    assert torch.equal(m31_multiply(x, a), m31_multiply_plain(a, x))
    A = torch.randint(0, 2**16, (4,) + shape, generator=g, device=cuda_device).to(torch.uint16)
    X = torch.randint(0, 2**16, (4,) + row, generator=g, device=cuda_device).to(torch.uint16)
    want = goldilocks_multiply_plain(A, X)
    assert torch.equal(goldilocks_multiply(A, X), want)
    assert torch.equal(goldilocks_multiply(X, A), want)
    assert torch.equal(goldilocks_multiply(A, X[:, 0]), want)  # fewer element axes


def test_main_path_3_small_on_cuda_matches_cpu(cuda_device):
    n = 2**12
    for p in (GOLDILOCKS, M31):
        F = gt.GF(p)
        x = F.Random(n, seed=1, device="cpu")
        y = F.Random(n, seed=2, low=1, device="cpu")
        gx, gy = F(x._data, device=cuda_device), F(y._data, device=cuda_device)
        ops = [lambda u, v: u * v, lambda u, v: u / v]
        if p == GOLDILOCKS:
            ops += [lambda u, v: u + v, lambda u, v: u - v, lambda u, v: np.reciprocal(v), lambda u, v: -u]
        for op in ops:
            got = op(gx, gy)
            assert got.device.type == "cuda"
            assert np.array_equal(np.asarray(got), np.asarray(op(x, y)))
        f = gt.Poly.Random(255, seed=3, field=F)
        counter = goldilocks_multiply if p == GOLDILOCKS else m31_multiply
        launches = counter.launches
        got = f(gx)
        torch.cuda.synchronize()
        assert counter.launches == launches + 36  # 16 inner + 4 for x^16 + 16 outer
        assert got.device.type == "cuda"
        assert np.array_equal(np.asarray(got), np.asarray(f(x)))


def test_limb_fields_on_cuda_match_cpu(cuda_device):
    for p in (BLS_R, GOLDILOCKS, 1099511627791):
        F = gt.GF(p)
        x = F.Random((3, 40), seed=4, device=cuda_device)
        vals = np.asarray(x, dtype=object)
        assert x._data.dtype == torch.uint16 and x.device.type == "cuda"
        assert all(0 <= int(v) < p for v in vals.reshape(-1))
        cx = F(x._data.cpu())
        y = F.Random(40, seed=5, low=1, device=cuda_device)
        cy = F(y._data.cpu())
        for op in (
            lambda u, v: u * v, lambda u, v: u + v, lambda u, v: u - v, lambda u, v: -u,
            lambda u, v: u**5, lambda u, v: u == v, lambda u, v: u[1:, ::3], lambda u, v: u.reshape(120),
            lambda u, v: v ** np.arange(40),
        ):
            assert np.array_equal(np.asarray(op(x, y)), np.asarray(op(cx, cy)))
        assert np.array_equal(np.asarray(x[0] / y[:1]), np.asarray(cx[0] / cy[:1]))
        assert np.array_equal(np.asarray(F.Zeros(4, device=cuda_device)), np.asarray(F.Zeros(4, device="cpu")))
        with pytest.raises(ZeroDivisionError):
            x / F.Zeros(40, device=cuda_device)


# torch._int_mm's shape rules (M > 16, K and N multiples of 8) met by padding
INT8_SHAPES = [(1, 1, 1), (17, 13, 9), (100, 300, 7), (33, 2048, 40), (5, 4100, 3), (40, 5, 160), (4096, 2048, 5888)]


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_matmul_ragged_shapes_match_cpu(cuda_device, shape):
    M, K, N = shape
    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    a[0, :] = -128  # the largest magnitudes a row can sum: 128^2 K < 2^31
    b[:, 0] = -128
    got = int8_matmul(a.to(cuda_device), b.T.contiguous().to(cuda_device))
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = int8_matmul(a, b.T)
    assert torch.equal(got.cpu(), want)
    # into a given output, from views whose rows are longer than K (read in place)
    wide_a = torch.zeros((M, K + 64), dtype=torch.int8, device=cuda_device)
    wide_b = torch.zeros((N, K + 32), dtype=torch.int8, device=cuda_device)
    wide_a[:, 32 : 32 + K], wide_b[:, :K] = a.to(cuda_device), b.T.to(cuda_device)
    out = torch.full((M, N), -1, dtype=torch.int32, device=cuda_device)
    int8_matmul(wide_a[:, 32 : 32 + K], wide_b[:, :K], out=out)
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_limb_matmul_on_cuda_matches_cpu(cuda_device, p):
    """Ragged shapes, a batched side, and every digit at p - 1 at a K past
    one block (the diagonal sums nearest their int32 bound)."""
    F = gt.GF(p)
    for sa, sb in (((5, 7), (7, 3)), ((17, 9), (9, 33)), ((2, 3, 20), (20, 6)), ((40, 2053), (2053, 5))):
        a, b = F.Random(sa, seed=1, device="cpu"), F.Random(sb, seed=2, device="cpu")
        got = F(a._data, device=cuda_device) @ F(b._data, device=cuda_device)
        assert got.device.type == "cuda" and torch.equal(got._data.cpu(), (a @ b)._data)
    K = 13315 + 5 if p == GOLDILOCKS else 2048 + 5
    full = F(np.full((3, K), p - 1, dtype=object), device=cuda_device)
    got = np.asarray(full @ full.T, dtype=object)
    assert all(int(v) == K % p for v in got.reshape(-1))


@pytest.mark.parametrize("p", [GOLDILOCKS, BLS_R])
def test_limb_ntt_on_cuda_matches_cpu(cuda_device, p):
    F = gt.GF(p)
    x = F.Random((2, 2**12), seed=3, device="cpu")
    k10 = goldilocks_multiply.launches
    X = np.fft.fft(F(x._data, device=cuda_device))
    assert X.device.type == "cuda" and torch.equal(X._data.cpu(), np.fft.fft(x)._data)
    assert torch.equal(np.fft.ifft(X)._data.cpu(), x._data)
    if p == GOLDILOCKS:
        assert goldilocks_multiply.launches > k10  # the twiddle multiply and the scaling


def test_poly_product_via_ntt_on_cuda_matches_cpu(cuda_device):
    """400 x 400 coefficients over GF(3 * 2^30 + 1): the NTT at N = 1024, K1
    and K2 launched; and a device division above its threshold."""
    F = gt.GF(P)
    rng = np.random.default_rng(4)
    a, b, d = (gt.Poly(rng.integers(1, P, n), field=F) for n in (400, 400, 256))
    before = (plane_matmul_data_right.launches, plane_matmul_data_left.launches)
    with gt.default_device(cuda_device):
        got = a * b
        q, r = divmod(got, d)
    assert plane_matmul_data_right.launches > before[0] and plane_matmul_data_left.launches > before[1]
    with gt.default_device("cpu"):
        assert got == a * b
        assert (q, r) == divmod(a * b, d)


# ----------------------------------------------------------------------
# Linear algebra over GF(q) (main path 6): the card against the CPU plain path
# ----------------------------------------------------------------------

LINALG_FIELDS = [
    (2, "jit-calculate"), (2**8, "jit-calculate"), (2**8, "jit-lookup"), (2**16, "jit-calculate"),
    (M31, "jit-calculate"), (GOLDILOCKS, "jit-calculate"),
]


def _linalg_input(F, shape, seed):
    rng = np.random.default_rng(seed)
    if F.order <= 2**62:
        return F(rng.integers(0, F.order, shape), device="cpu")
    return F((rng.integers(0, 2**62, shape).astype(object) * 4) % F.order, device="cpu")


@pytest.mark.parametrize(["q", "mode"], LINALG_FIELDS)
def test_linalg_on_cuda_matches_cpu(cuda_device, q, mode):
    """row_reduce, rank, inv (or its singular error), det and PLU of the
    device loops (A.size > 4096), and for int storage the char and min polys
    at n = 64; the card's results equal the CPU's, and the input stays as it
    was."""
    F = gt.GF(q, compile=mode)
    try:
        n = 65 if q == GOLDILOCKS else 96  # Goldilocks: the plain Fermat reciprocal is slow on the host
        A = _linalg_input(F, (n, n + 3), 5)
        Ac = F(A._data, device=cuda_device)
        before = Ac._data.clone()
        got, want = Ac.row_reduce(), A.row_reduce()
        assert got.device.type == "cuda" and torch.equal(got._data.cpu(), want._data)
        assert torch.equal(Ac._data, before)
        assert np.linalg.matrix_rank(Ac) == np.linalg.matrix_rank(A)
        B, Bc = A[:, :n], Ac[:, :n]
        try:
            want = np.linalg.inv(B)
        except np.linalg.LinAlgError:
            with pytest.raises(np.linalg.LinAlgError):
                np.linalg.inv(Bc)
        else:
            assert torch.equal(np.linalg.inv(Bc)._data.cpu(), want._data)
        assert torch.equal(np.linalg.det(Bc)._data.cpu(), np.linalg.det(B)._data)
        for g, w in zip(Bc.plu_decompose(), B.plu_decompose()):
            assert torch.equal(g._data.cpu(), w._data)
        assert torch.equal(Ac._data, before)
        if F._meta.storage == "int":
            C, Cc = A[:64, :64], Ac[:64, :64]
            assert Cc.characteristic_poly() == C.characteristic_poly()
            assert Cc.minimal_poly() == C.minimal_poly()
    finally:
        F.compile("auto")


@pytest.mark.parametrize(["q", "mode"], LINALG_FIELDS[1:])
def test_linalg_column_steps_never_read_back(cuda_device, q, mode):
    """_row_reduce_data (no more columns than rows: no early-exit check),
    _plu_data, _det_data and charpoly_data under sync debug mode "error":
    no step of theirs waits for the card. One warm-up call first puts the
    field's tables and constants on the card."""
    F = gt.GF(q, compile=mode)
    try:
        meta, mode = F._meta, F._mode
        A = _linalg_input(F, (40, 40), 6)
        a = F(A._data, device=cuda_device)._data
        wide = torch.cat([a, a], dim=-1)
        calls = [
            lambda: _linalg._row_reduce_data(meta, mode, wide, 40),
            lambda: _linalg._plu_data(meta, mode, a),
            lambda: _linalg._det_data(meta, mode, a),
        ]
        if meta.storage == "int":
            calls.append(lambda: _charpoly.charpoly_data(meta, mode, a))
        for call in calls:
            call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for call in calls:
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        F.compile("auto")


# (order, mode): the element functions' device routes. K6 reads the LOG
# table for orders <= 2^20; GF(2^31 - 1) (K9) and GF(3 * 2^30 + 1) run the
# batched Pohlig-Hellman; the square roots are K8-A for GF(2^m), one ladder
# for q = 3 mod 4, Atkin for q = 5 mod 8 (GF(5^3)), Tonelli-Shanks for
# GF(65537), GF(3 * 2^30 + 1) and Goldilocks (K10, limbs), and the tables
# (K6) in lookup mode.
ELEMENT_FIELDS = [
    (2**8, "jit-calculate"), (2**8, "jit-lookup"), (2**16, "jit-calculate"), (3**5, "jit-calculate"),
    (3**5, "jit-lookup"), (5**3, "jit-calculate"), (65537, "jit-calculate"), (M31, "jit-calculate"),
    (P, "jit-calculate"), (GOLDILOCKS, "jit-calculate"),
]


@pytest.mark.parametrize(["q", "mode"], ELEMENT_FIELDS)
def test_element_functions_on_cuda_match_cpu(cuda_device, q, mode):
    """log, sqrt of squares, is_square, field_trace and field_norm of 4096
    elements: the card's results equal the CPU plain versions'; the log of
    orders <= 2^20 launches K6."""
    F = gt.GF(q, compile=mode)
    try:
        x = _linalg_input(F, 256 if q == GOLDILOCKS else 4096, 7)  # Goldilocks' log is the host's
        x = F(np.where(np.asarray(x) == 0, 1, np.asarray(x)).astype(np.asarray(x).dtype), device="cpu")
        xc = F(x._data, device=cuda_device)
        k6 = lookup_log.launches
        assert np.array_equal(xc.log(), x.log())
        if q <= 2**20:
            assert lookup_log.launches > k6
        sq, sqc = x * x, xc * xc
        r = np.sqrt(sqc)
        assert r.device.type == "cuda" and torch.equal(r._data.cpu(), np.sqrt(sq)._data)
        assert np.array_equal(xc.is_square(), x.is_square())
        for name in ("field_trace", "field_norm"):
            assert torch.equal(getattr(xc, name)()._data.cpu(), getattr(x, name)()._data)
    finally:
        F.compile("auto")


@pytest.mark.parametrize("q", [65537, M31, P, GOLDILOCKS])
def test_log_and_sqrt_loops_never_read_back(cuda_device, q):
    """The batched Pohlig-Hellman (int storage) and the square root forms
    (Tonelli-Shanks for GF(65537), GF(3 * 2^30 + 1) and Goldilocks) under
    sync debug mode "error": no step of theirs waits for the card. One
    warm-up call first puts the constants and baby tables on the card."""
    from galois_tpu_torch.ops import _dlog

    F = gt.GF(q)
    ops = get_ops(F._meta, F._mode)
    x = _linalg_input(F, 2048, 8)
    a = F(x._data, device=cuda_device)._data
    sq = ops.multiply(a, a)
    calls = [lambda: ops.sqrt(sq)]
    if F._meta.storage == "int" and q > 2**20:
        a1 = torch.where(a == 0, torch.ones_like(a), a)
        calls.append(lambda: _dlog._device_log(F._meta, ops, a1))
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("q", [2**8, 2**16, 3**5])
def test_chien_scan_on_cuda_matches_cpu(cuda_device, q):
    """Poly.roots with multiplicities over fields of orders <= 2^20 scan every
    element on the card (K8 for GF(2^8), K7 for GF(2^16)); the roots equal
    those of the CPU's scan."""
    F = gt.GF(q)
    rng = np.random.default_rng(q % 1000)
    roots = [int(v) for v in rng.choice(q, 40, replace=False)]
    f = gt.Poly.Roots(roots, [1 + i % 3 for i in range(40)], field=F)
    launches = gf2m_multiply.launches + gf2m_multiply_swar.launches
    with gt.default_device(cuda_device):
        got = f.roots(multiplicity=True)
    if q in (2**8, 2**16):
        assert gf2m_multiply.launches + gf2m_multiply_swar.launches > launches
    with gt.default_device("cpu"):
        want = f.roots(multiplicity=True)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0])) and np.array_equal(got[1], want[1])
    assert sorted(np.asarray(got[0]).tolist()) == sorted(roots)


# ----------------------------------------------------------------------
# K12 (the LFSR scan), K13 (the long Berlekamp-Massey scan), K14 (GF(2^m),
# m > 32, products and powers on limbs)
# ----------------------------------------------------------------------

# (order, modulus): fields whose public arithmetic runs K14
LIMB_BINARY_FIELDS = [(2**100, None), (2**128, "x^128 + x^7 + x^2 + x + 1")]


@functools.lru_cache(maxsize=None)
def _limb_binary_field(q, f):
    """Built once: a given modulus is tested for irreducibility at every construction."""
    return gt.GF(q) if f is None else gt.GF(q, irreducible_poly=f)


# (m, modulus f as an int): W = 1, 2, 3, 4, 5, 7 and 9 64-bit words, NIST's B-163 ... B-571 and
# GCM's moduli. The kernel and its plain version compute the same map for any f of degree m, so no
# field is built (a given modulus's irreducibility test takes minutes of host time at m = 571).
K14_MODULI = [
    (64, 2**64 + 2**4 + 2**3 + 2 + 1), (128, 2**128 + 2**7 + 2**2 + 2 + 1), (163, 2**163 + 2**7 + 2**6 + 2**3 + 1),
    (233, 2**233 + 2**74 + 1), (283, 2**283 + 2**12 + 2**7 + 2**5 + 1), (409, 2**409 + 2**87 + 1),
    (571, 2**571 + 2**10 + 2**5 + 2**2 + 1),
]


def _random_limbs(m, shape, gen):
    """Uniform elements of GF(2)[x]/f, deg f = m, as planar uint16 limbs on gen's device."""
    L = -(-m // 16)
    top = m - 16 * (L - 1)
    masks = torch.tensor([0xFFFF] * (L - 1) + [(1 << top) - 1], device=gen.device).reshape((L,) + (1,) * len(shape))
    r = torch.randint(0, 2**16, (L,) + tuple(shape), generator=gen, device=gen.device) & masks
    return r.to(torch.int32).to(torch.int16).view(torch.uint16)


@pytest.mark.parametrize(["m", "fi"], K14_MODULI + EDGE_MODULI + DENSE_MODULI)
def test_gf2_limb_kernels_match_plain(cuda_device, m, fi):
    """K14's product, square and power entries against their plain versions
    on the card: whole operands, a one-element operand (stride 0), an
    element-axis broadcast (materialized), public exponents (0, 1, the
    reciprocal 2^m - 2, 2^m - 1, the square root 2^(m - 1) among them) and
    62-bit exponent words with zeros; sparse moduli (the fold by terms) and
    dense ones (the byte table)."""
    from galois_tpu_torch.ops._limb_binary import (
        fold_inputs,
        gf2_limb_multiply,
        gf2_limb_multiply_plain,
        gf2_limb_power,
        gf2_limb_power_plain,
        gf2_limb_square,
        gf2_limb_square_plain,
    )

    assert (fold_inputs(m, fi)[1] is None) == ((m, fi) in DENSE_MODULI)
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    a, b = _random_limbs(m, (1000,), gen), _random_limbs(m, (1000,), gen)
    c, d = _random_limbs(m, (7, 1), gen), _random_limbs(m, (1, 9), gen)
    one = b[:, :1].reshape(-1)
    cases = [
        (gf2_limb_multiply(a, b, m, fi), gf2_limb_multiply_plain(a, b, m, fi)),
        (gf2_limb_multiply(a, one, m, fi), gf2_limb_multiply_plain(a, one, m, fi)),
        (gf2_limb_multiply(one, a, m, fi), gf2_limb_multiply_plain(one, a, m, fi)),
        (gf2_limb_multiply(c, d, m, fi), gf2_limb_multiply_plain(c, d, m, fi)),
        (gf2_limb_square(a, m, fi), gf2_limb_square_plain(a, m, fi)),
    ]
    u = a[:, :16]  # the plain ladders run a product a bit
    for e in (0, 1, 3, 2**m - 2, 2**m - 1, 2 ** (m - 1), 2**70 + 5):
        cases.append((gf2_limb_power(u, e, m, fi), gf2_limb_power_plain(u, e, m, fi)))
    words = [torch.randint(0, 2**62, (16,), generator=gen, device=cuda_device) for _ in range(2)]
    words[0][::3] = 0
    words[1][::2] = 0
    cases.append((gf2_limb_power(u, words, m, fi, 124), gf2_limb_power_plain(u, words, m, fi, 124)))
    cases.append((gf2_limb_power(one, words, m, fi, 100), gf2_limb_power_plain(one, words, m, fi, 100)))
    zero_words = [torch.zeros(16, dtype=torch.int64, device=cuda_device)]
    cases.append((gf2_limb_power(u, zero_words, m, fi, 62), gf2_limb_power_plain(u, zero_words, m, fi, 62)))
    for got, want in cases:
        assert got.device.type == "cuda" and torch.equal(got.cpu().view(torch.int16), want.cpu().view(torch.int16))


@pytest.mark.parametrize(["q", "f"], LIMB_BINARY_FIELDS)
def test_limb_binary_fields_on_cuda_match_cpu(cuda_device, q, f):
    """The public arithmetic of GF(2^100) and GF(2^128) on the card equals
    the CPU plain versions'; K14 is launched."""
    from galois_tpu_torch.ops._limb_binary import gf2_limb_multiply, gf2_limb_power

    F = _limb_binary_field(q, f)
    x = F.Random(512, seed=1, device="cpu")
    y = F.Random(512, low=1, seed=2, device="cpu")
    xc, yc = F(x._data, device=cuda_device), F(y._data, device=cuda_device)
    k14 = gf2_limb_multiply.launches + gf2_limb_power.launches
    e = np.arange(512, dtype=np.int64) * 977
    for got, want in ((xc * yc, x * y), (xc / yc, x / y), (xc**e, x**e), (np.sqrt(xc), np.sqrt(x)), (xc + yc, x + y)):
        assert got.device.type == "cuda" and torch.equal(got._data.cpu().view(torch.int16), want._data.view(torch.int16))
    assert gf2_limb_multiply.launches + gf2_limb_power.launches > k14


def test_digit_fields_on_cuda_match_cpu(cuda_device):
    F = gt.GF(3**30)
    x = F.Random(4096, seed=1, device="cpu")
    y = F.Random(4096, low=1, seed=2, device="cpu")
    xc, yc = F(x._data, device=cuda_device), F(y._data, device=cuda_device)
    for got, want in ((xc * yc, x * y), (xc / yc, x / y), (xc - yc, x - y), (xc + yc, x + y)):
        assert got.device.type == "cuda" and torch.equal(got._data.cpu(), want._data)


# (order, taps): GF(2), GF(2^8) with a warp and with several warps, GF(2^31 - 1), GF(3^5) by its tables,
# and above 1024 taps (the state in shared memory, and above 19,008 taps in global memory)
LFSR_CASES = [
    (2, 20), (2**8, 32), (2**8, 100), (2**8, 1024), (2**31 - 1, 16), (3**5, 7), (2**16, 40), (65537, 5), (2, 5000),
    (2**8, 1500), (2**8, 20000), (2**31 - 1, 19009),
]


@pytest.mark.parametrize(["q", "k"], LFSR_CASES)
@pytest.mark.parametrize("kind", ["fibonacci", "galois"])
def test_lfsr_step_kernel_matches_plain(cuda_device, q, k, kind):
    """K12 against its plain tick loop on the card, forwards and backwards."""
    from galois_tpu_torch.fields._hostfield import get_host_field
    from galois_tpu_torch.ops._lfsr_scan import lfsr_step, lfsr_step_plain

    F = gt.GF(q)
    ops = get_ops(F._meta, F._mode)
    rng = np.random.default_rng(k)
    state = F(rng.integers(0, q, k), device=cuda_device)._data
    taps = F(rng.integers(1, q, k), device=cuda_device)._data
    end = k - 1 if kind == "fibonacci" else 0
    inv = get_host_field(F._meta).reciprocal(int(taps[end]))
    for direction in ("forward", "backward"):
        n = 300
        s, y = lfsr_step(ops, state, taps, n, kind, direction, inv)
        inv_t = torch.full((1,), inv, dtype=state.dtype, device=cuda_device)
        s_p, y_p = lfsr_step_plain(ops, state, taps, n, kind, direction, inv_t)
        assert torch.equal(s, s_p) and torch.equal(y, y_p)


# One field of each kind field_scan.cuh has: GF(2); GF(p) (Barrett); GF(2^17) (carry-less);
# GF(2^8), GF(2^16) (binary tables); GF(3^5) (odd tables). K12's block form takes 32 ticks at a time.
# The long count: 10007 ticks, or 2063 (64 blocks and a tail) where the plain loop's product is a
# chain of torch passes (GF(65537), GF(2^17), GF(3^5): about a millisecond a tick on the card).
BLOCK_FIELDS = {2: 10007, 2**31 - 1: 10007, 65537: 2063, 2**17: 2063, 2**8: 10007, 2**16: 10007, 3**5: 2063}


@pytest.mark.parametrize("k", [1, 31, 32, 33, 1024])
@pytest.mark.parametrize("q", list(BLOCK_FIELDS))
def test_lfsr_step_block_form_matches_plain(cuda_device, q, k):
    """K12's block form (and its tick-by-tick rest) against the plain tick
    loop: every mode, at the field's long count (which builds the block
    form's matrices into ``blocks``), then at step counts 1, B - 1, B,
    B + 1, 2B (the first count that takes blocks, two of them) and 2B + 1
    (B = 32) with those matrices."""
    from galois_tpu_torch.fields._hostfield import get_host_field
    from galois_tpu_torch.ops._lfsr_scan import BLOCK_TICKS as B
    from galois_tpu_torch.ops._lfsr_scan import lfsr_step, lfsr_step_plain

    F = gt.GF(q)
    ops = get_ops(F._meta, F._mode)
    rng = np.random.default_rng(k + q % 1000)
    state = F(rng.integers(0, q, k), device=cuda_device)._data
    taps = F(rng.integers(1, q, k), device=cuda_device)._data
    for kind in ("fibonacci", "galois"):
        end = k - 1 if kind == "fibonacci" else 0
        inv = get_host_field(F._meta).reciprocal(int(taps[end]))
        inv_t = torch.full((1,), inv, dtype=state.dtype, device=cuda_device)
        blocks = {}
        for direction in ("forward", "backward"):
            for n in (BLOCK_FIELDS[q], 1, B - 1, B, B + 1, 2 * B, 2 * B + 1):
                s, y = lfsr_step(ops, state, taps, n, kind, direction, inv, blocks)
                s_p, y_p = lfsr_step_plain(ops, state, taps, n, kind, direction, inv_t)
                assert torch.equal(s, s_p) and torch.equal(y, y_p), (kind, direction, n)
        assert len(blocks) == 2


@pytest.mark.parametrize("k", [1, 32, 33, 1024])
@pytest.mark.parametrize("q", [2, 2**31 - 1, 2**17, 2**8, 3**5])
def test_lfsr_block_inputs_built_on_the_card_match_plain(cuda_device, q, k):
    """The block form's matrices as the wrapper builds them (one launch of
    the kernel on the k basis states) equal those of the plain tick loop on
    the identity, in the kernel's layout, for every mode."""
    from galois_tpu_torch.fields._hostfield import get_host_field
    from galois_tpu_torch.ops._lfsr_scan import _blocks, _field, block_inputs, block_matrices

    F = gt.GF(q)
    ops = get_ops(F._meta, F._mode)
    taps = F(np.random.default_rng(k).integers(1, q, k), device=cuda_device)._data
    for kind in ("fibonacci", "galois"):
        inv = get_host_field(F._meta).reciprocal(int(taps[k - 1 if kind == "fibonacci" else 0]))
        for direction in ("forward", "backward"):
            got = _blocks(ops, taps, kind, direction, inv, _field(ops, taps.device))
            inv_t = torch.full((1,), inv, dtype=taps.dtype, device=cuda_device)
            want = block_inputs(ops, *block_matrices(ops, taps, kind, direction, inv_t)[:2], k)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w), (kind, direction)


def test_lfsr_keeps_its_block_form(cuda_device):
    """A register builds its block form once a direction, on the first call
    of BUILD_TICKS ticks or more (one more launch), and uses it from then
    on; shorter first calls run tick by tick and build nothing. The outputs
    equal the same register's on the CPU."""
    from galois_tpu_torch.ops._lfsr_scan import BUILD_TICKS, lfsr_step

    F = gt.GF(2**8)
    c = gt.ReedSolomon(255, 223).generator_poly.reverse()
    state = F(np.arange(1, 33))
    for cls in (gt.FLFSR, gt.GLFSR):
        reg, ref = cls(c, state=F(state._data, device=cuda_device)), cls(c, state=F(state._data, device="cpu"))
        for n, launches, built in ((100, 1, 0), (BUILD_TICKS, 2, 1), (3 * BUILD_TICKS + 5, 1, 1), (-BUILD_TICKS, 2, 2),
                                   (-100, 1, 2)):
            before = lfsr_step.launches
            y, y_ref = reg.step(n), ref.step(n)
            assert lfsr_step.launches - before == launches and len(reg._blocks) == built, (cls.__name__, n)
            assert torch.equal(y._data.cpu(), y_ref._data) and torch.equal(reg.state._data.cpu(), ref.state._data)


# K13's fields: every kind of field_scan.cuh in both storages where it has both (GF(2) only uint8,
# GF(2^m > 16) only int64)
BM_FIELDS = [2, 2**8, 2**16, 3**5, 3**7, 251, 2**31 - 1, 2**17]


@pytest.mark.parametrize("q", BM_FIELDS)
def test_berlekamp_massey_long_kernel_matches_plain(cuda_device, q, monkeypatch):
    """K13 on the card against its plain scan on the same inputs (a prime
    field's on the host, where it is quicker; an extension field's on the
    card, whose kernels take its products and reciprocals), at N not a
    multiple of the 32 steps of a GF(2) block or of a batch: 600 random elements (complexity near N / 2: warp 0, then the CTA
    from 256 elements); 600 and 300 of an LFSR's output (runs of d = 0,
    taken 32 at a time), that output then random elements (L changes inside
    a block), the impulse at 600 and 300 (L = N), all zeros; N = 1 and 33;
    GF(2) also at its word edges; the random sequence and the 600 LFSR
    outputs in the global-memory form (the shared-memory budget set to 0);
    and GF(2) at 20,000 elements, too long for the plain scan, where the
    connection polynomial must annihilate the sequence."""
    from galois_tpu_torch.ops import _lfsr_scan
    from galois_tpu_torch.ops._lfsr_scan import berlekamp_massey_long, berlekamp_massey_long_plain

    F = gt.GF(q)
    ops = get_ops(F._meta, F._mode)
    rng = np.random.default_rng(q % 1000)
    lf = gt.FLFSR(gt.Poly([1] + [int(v) for v in rng.integers(0, q, 11)] + [1], field=F), state=F(rng.integers(1, q, 12), device=cuda_device))
    seqs = [F(rng.integers(0, q, 600), device=cuda_device)._data]
    y = lf.step(600)._data
    seqs += [y, y[:300], torch.cat([y[:170], F(rng.integers(0, q, 130), device=cuda_device)._data]),
             F([0] * 599 + [1], device=cuda_device)._data, F([0] * 299 + [1], device=cuda_device)._data,
             F([0] * 300, device=cuda_device)._data, F([1], device=cuda_device)._data,
             F(rng.integers(0, q, 33), device=cuda_device)._data]
    if q == 2:
        seqs += [F(rng.integers(0, 2, n), device=cuda_device)._data for n in (31, 32, 1023, 1024, 1025)]
    plain = [berlekamp_massey_long_plain(ops, seq.cpu() if F.degree == 1 else seq) for seq in seqs]

    def same(i):
        c, L = berlekamp_massey_long(ops, seqs[i])
        c_p, L_p = plain[i]
        assert int(L) == int(L_p) and torch.equal(c.cpu(), c_p.cpu()), (q, seqs[i].shape[0], int(L), int(L_p))

    for i in range(len(seqs)):
        same(i)
    monkeypatch.setattr(_lfsr_scan, "BM_SMEM_BYTES", 0)
    for i in range(2):
        same(i)
    monkeypatch.undo()
    if q == 2:
        seq = F(rng.integers(0, 2, 20000), device=cuda_device)._data
        c, L = berlekamp_massey_long(ops, seq)
        assert 9800 < int(L) < 10200
        # the connection polynomial regenerates the sequence: sum_i c[i] s[t - i] = 0 for t >= L
        cc, s = c[: int(L) + 1].to(torch.float32), seq.to(torch.float32)
        win = s.unfold(0, int(L) + 1, 1).flip(-1)  # rows s[t], s[t - 1], ..., s[t - L]
        assert not bool(((win @ cc).to(torch.int64) & 1).any())


def test_lfsr_and_berlekamp_massey_never_read_back(cuda_device):
    """One K12 step and one long K13 scan under sync debug mode "error"."""
    from galois_tpu_torch.ops._lfsr_scan import berlekamp_massey_long, lfsr_step

    F = gt.GF(2**8)
    ops = get_ops(F._meta, F._mode)
    state = F(np.arange(1, 33), device=cuda_device)._data
    taps = F(np.arange(2, 34), device=cuda_device)._data
    seq = F(np.arange(4096) % 256, device=cuda_device)._data
    calls = [lambda: lfsr_step(ops, state, taps, 5000, "galois", "forward"), lambda: berlekamp_massey_long(ops, seq)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# Element assignment, outer products and pickling on the card: each field's storage kind (uint8, int64,
# uint16 limbs, int64 digits), against the same calls on CPU copies
API_FIELDS = [2**8, 2**16, 2**31 - 1, GOLDILOCKS, 2**100, 3**30]


def _same_storage(got, want):
    a, b = got._data.cpu(), want._data
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


@pytest.mark.parametrize("q", API_FIELDS)
def test_assignment_on_cuda_matches_cpu(cuda_device, q):
    """Scalars, slices, masks and index tensors (on the card and on the host)
    written into a CUDA array give the CPU's integers; the array stays on
    the card, and a slice taken before keeps its values."""
    F = gt.GF(q)
    x = F.Random(4096, seed=1, device="cpu")
    xc = F(x._data, device=cuda_device)
    head = xc[:8]
    head_before = head._data.clone()
    mask = torch.arange(4096) % 2 == 0
    idx = torch.randperm(4096, generator=torch.Generator().manual_seed(2))[:512]  # distinct: no write races
    vals = F.Random(512, seed=3, device="cpu")
    writes = [
        (lambda a: a.__setitem__(0, 5), None),
        (lambda a: a.__setitem__(slice(None, None, 3), 7), None),
        (lambda a: a.__setitem__(mask, 1), mask),
        (lambda a: a.__setitem__(idx, vals), idx),
        (lambda a: a.__setitem__((Ellipsis, slice(100, 102)), [q - 1, 0]), None),
    ]
    for write, index in writes:
        write(x)
        if index is not None:  # the same index as a tensor on the card
            if index is mask:
                xc[mask.to(cuda_device)] = 1
            else:
                xc[idx.to(cuda_device)] = F(vals._data, device=cuda_device)
        else:
            write(xc)
        assert xc.device.type == "cuda" and _same_storage(xc, x)
    assert torch.equal(head._data, head_before)


@pytest.mark.parametrize("q", API_FIELDS + [2**128])
def test_outer_on_cuda_matches_cpu(cuda_device, q):
    """np.multiply.outer and np.add.outer on the card (the multiply kernels on
    broadcast operands) equal the CPU's; a zero divisor raises."""
    F = gt.GF(q) if q != 2**128 else gt.GF(q, irreducible_poly="x^128 + x^7 + x^2 + x + 1")
    a = F.Random(96, seed=4, device="cpu")
    b = F.Random(80, low=1, seed=5, device="cpu")
    ac, bc = F(a._data, device=cuda_device), F(b._data, device=cuda_device)
    for ufunc in (np.multiply, np.add, np.subtract, np.true_divide):
        got, want = ufunc.outer(ac, bc), ufunc.outer(a, b)
        assert got.shape == (96, 80) and got.device.type == "cuda" and _same_storage(got, want)
    ac[3] = 0
    with pytest.raises(ZeroDivisionError):
        np.true_divide.outer(bc, ac)


@pytest.mark.parametrize("q", API_FIELDS)
def test_pickle_round_trip_from_cuda(cuda_device, q):
    """A pickled CUDA array comes back equal, of its class, on the default
    device at load time: the card, or the CPU when that is the default."""
    import pickle

    F = gt.GF(q)
    x = F.Random((64, 3), seed=6, device=cuda_device)
    data = pickle.dumps(x)
    with gt.default_device(cuda_device):
        y = pickle.loads(data)
    with gt.default_device("cpu"):
        z = pickle.loads(data)
    assert type(y) is F and y.device.type == "cuda" and _same_storage(y, z)
    assert z.device.type == "cpu" and np.array_equal(np.asarray(z), np.asarray(x))


def test_sharded_fft_and_decode_at_one_nccl_rank(cuda_device, tmp_path):
    """parallel/ at one NCCL rank on the card: sharded_fft over GF(3*2^30+1),
    Goldilocks and BLS12-381 r (and back) and sharded_decode of RS(255,223),
    with errors and with erasures, exactly equal to field_fft and
    code.decode(..., errors=True)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from galois_tpu_torch.ops._ntt import field_fft
    from galois_tpu_torch.parallel import sharded_decode, sharded_fft

    dev = torch.device("cuda", torch.cuda.current_device())
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
        for q, N in ((3 * 2**30 + 1, 2**12), (GOLDILOCKS, 2**10), (BLS_R, 2**8)):
            F = gt.GF(q)
            x = F.Random(N, seed=N, device=dev)
            X = sharded_fft(F, x, mesh, "x")
            assert X.device == dev and torch.equal(X._data, field_fft(x)._data)
            assert torch.equal(sharded_fft(F, X, mesh, "x", inverse=True)._data, x._data)
        rs = gt.ReedSolomon(255, 223)
        gen = torch.Generator(device=dev).manual_seed(7)
        bad = rs.encode(rs.field.Random((64, 223), generator=gen, device=dev))._data.clone()
        bad[:, 3] ^= 9
        bad[::2, 100] ^= 1
        era = torch.zeros_like(bad, dtype=torch.bool)
        era[:, 50] = True
        for kw in ({}, {"erasures": era}):
            dec, n_err = sharded_decode(rs, rs.field._view(bad), mesh, "x", **kw)
            want, want_n = rs.decode(rs.field._view(bad), output="codeword", errors=True, **kw)
            assert dec.device == dev and torch.equal(dec._data, want._data)
            assert np.array_equal(n_err.cpu().numpy(), want_n)
    finally:
        dist.destroy_process_group()


# CUDA-graph capture, the counterpart of the JAX package's jax.jit: (order, irreducible poly, mode) of
# main path 11's arithmetic fields
CAPTURE_FIELDS = [(2**8, None, "auto"), (2**16, None, "jit-lookup"), (M31, None, "auto"), (GOLDILOCKS, None, "auto"),
                  (2**128, "x^128 + x^7 + x^2 + x + 1", "auto"), (3**5, None, "auto")]


def _captured(fn):
    """fn() captured in a CUDA graph, any host sync during the capture an
    error: (the graph, the outputs it writes)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return graph, out


def _same_result(out, eager):
    if isinstance(eager, tuple):
        return all(_same_result(o, e) for o, e in zip(out, eager))
    if isinstance(out, torch.Tensor):  # a device result where the eager call returns a host one
        host = out.cpu().numpy()
        return host.dtype == np.asarray(eager).dtype and np.array_equal(host, eager)
    return torch.equal(out._data, eager._data)


@pytest.mark.parametrize(["q", "f", "mode"], CAPTURE_FIELDS, ids=[f"{q}-{m}" for q, _, m in CAPTURE_FIELDS])
def test_arithmetic_replays_equal_eager_calls(cuda_device, q, f, mode):
    """a * b + a, a / b, a ** 3 and np.reciprocal captured without a host
    sync; a replay equals the eager call, and after new values are copied
    into the inputs in place, the next replay equals the eager call on them."""
    F = gt.GF(q) if f is None else gt.GF(q, irreducible_poly=f)
    F.compile(mode)
    try:
        gen = torch.Generator(device=cuda_device).manual_seed(q % 1009)
        a = F.Random(2**16, generator=gen, device=cuda_device)
        b = F.Random(2**16, low=1, generator=gen, device=cuda_device)
        for fn in (lambda: a * b + a, lambda: a / b, lambda: a**3, lambda: np.reciprocal(b)):
            eager = fn()
            graph, out = _captured(fn)
            graph.replay()
            torch.cuda.synchronize()
            assert _same_result(out, eager)
            a._data.copy_(F.Random(2**16, generator=gen, device=cuda_device)._data)
            b._data.copy_(F.Random(2**16, low=1, generator=gen, device=cuda_device)._data)
            graph.replay()
            torch.cuda.synchronize()
            assert _same_result(out, fn())
    finally:
        F.compile("auto")


@pytest.mark.parametrize("q", [2**8, 31, 3**5, GOLDILOCKS])
def test_methods_replay_equal_eager_calls(cuda_device, q):
    """The methods of the JAX package's jit tests captured without a host
    sync: field_trace, field_norm, vector, additive_order,
    multiplicative_order, log, plu_decompose (16 x 16: the host route
    eagerly, the device route under capture), is_square and sqrt. The
    replays equal the eager calls; where jax.jit raises (the Goldilocks
    field's vector, additive_order, multiplicative_order and log), the
    capture raises NotImplementedError."""
    F = gt.GF(q)
    gen = torch.Generator(device=cuda_device).manual_seed(q % 1013)
    x = F.Random(4096, low=1, generator=gen, device=cuda_device)
    sq, mat = x * x, x[:256].reshape(16, 16)
    raising = {"vector", "additive_order", "multiplicative_order", "log"} if q == GOLDILOCKS else set()
    calls = {
        "field_trace": lambda: x.field_trace(), "field_norm": lambda: x.field_norm(), "vector": lambda: x.vector(),
        "additive_order": lambda: x.additive_order(), "multiplicative_order": lambda: x.multiplicative_order(),
        "log": lambda: x.log(), "plu_decompose": lambda: mat.plu_decompose(), "is_square": lambda: sq.is_square(),
        "sqrt": lambda: sq.sqrt(),
    }
    for name, fn in calls.items():
        if name in raising:
            with pytest.raises(NotImplementedError):
                _captured(fn)
            continue
        eager = fn()
        torch.cuda.synchronize()
        graph, out = _captured(fn)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_result(out, eager), name
