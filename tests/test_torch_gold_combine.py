"""The Goldilocks combine of the limb matmul (kernel K16,
``ops/_limb_matmul.py::goldilocks_combine``, ``csrc/gold_combine.cu``) on
the CPU.

The plain version, which CPU tensors take, against Python ints for random
int32 diagonals up to their worst case, with and without accumulation and
into a view of a longer row; the wrapper's checks; CPU tensors leave the
kernel's launch counter alone. The kernel's own arithmetic (the 32 x 64-bit
products into a 128-bit sum, and the reduction by 2^64 = 2^32 - 1 and
2^96 = -1) is modelled step by step in Python ints with 64-bit wrapping,
as ``csrc/gold_combine.cu`` computes it, and held to exact residues.
"""

import numpy as np
import pytest
import torch

import galois_tpu_torch as gt
from galois_tpu_torch.ops import _limb_matmul
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops._limb_matmul import goldilocks_combine, goldilocks_combine_plain

P = 2**64 - 2**32 + 1
S = 19
M64 = 2**64 - 1
EPS = 2**32 - 1


@pytest.fixture(scope="module")
def ops():
    return get_ops(gt.GF(P)._meta, "jit-calculate")


def _highs():
    """The largest sum of each diagonal: its digit pairs times 127^2 times
    the longest K block."""
    return [(min(s, 9) - max(0, s - 9) + 1) * 127**2 * _limb_matmul._MAX_BLOCK_K for s in range(S)]


def _diagonals(rows, cols, seed, highs=None):
    rng = np.random.default_rng(seed)
    highs = _highs() if highs is None else highs
    d = np.stack([rng.integers(0, h, (rows, cols), endpoint=True) for h in highs])
    d[:, 0, 0] = highs  # one element at the worst case
    d[:, -1, -1] = 0
    return torch.from_numpy(d.astype(np.int32))


def _values(out):
    limbs = out.to(torch.int64).numpy().astype(object)
    return limbs[0] + (limbs[1] << 16) + (limbs[2] << 32) + (limbs[3] << 48)


def _host(diag, prev=None):
    d = diag.to(torch.int64).numpy().astype(object)
    x = sum(d[s] << (7 * s) for s in range(S))
    return (x if prev is None else x + prev) % P


def test_highs_fit_int32_and_match_the_block():
    """The worst diagonal (10 pairs) of a full block stays below 2^31."""
    assert max(_highs()) == 10 * 127**2 * _limb_matmul._MAX_BLOCK_K < 2**31 <= max(_highs()) + 10 * 127**2
    assert _limb_matmul._GOLD_BOUND >= sum(h << (7 * s) for s, h in enumerate(_highs()))


@pytest.mark.parametrize("rows,cols,seed", [(1, 1, 0), (3, 5, 1), (17, 33, 2), (64, 40, 3)])
def test_plain_combine_matches_python_ints(ops, rows, cols, seed):
    diag = _diagonals(rows, cols, seed)
    out = torch.empty((4, rows, cols), dtype=torch.uint16)
    assert goldilocks_combine_plain(ops, diag, out) is out
    assert np.array_equal(_values(out), _host(diag))


@pytest.mark.parametrize("highs", ["worst", "int32"])
def test_plain_combine_at_the_largest_diagonals(ops, highs):
    """Every diagonal at its worst case over a full block, and at 2^31 - 1
    (the most any int32 diagonal can hold)."""
    h = _highs() if highs == "worst" else [2**31 - 1] * S
    diag = torch.tensor(h, dtype=torch.int32).reshape(S, 1, 1).expand(S, 4, 6).contiguous()
    out = goldilocks_combine_plain(ops, diag, torch.empty((4, 4, 6), dtype=torch.uint16))
    assert set(_values(out).reshape(-1)) == {sum(v << (7 * s) for s, v in enumerate(h)) % P}


def test_plain_combine_accumulates_into_a_strided_view(ops):
    """A later K block adds into the residues a view of longer rows holds;
    the columns around the view stay as they were."""
    rows, cols = 9, 21
    d1, d2 = _diagonals(rows, cols, 4), _diagonals(rows, cols, 5)
    wide = torch.full((4, rows, cols + 11), 7, dtype=torch.uint16)
    view = wide[:, :, 3 : 3 + cols]
    goldilocks_combine(ops, d1, view)
    first = _values(view)
    assert np.array_equal(first, _host(d1))
    goldilocks_combine(ops, d2, view, accumulate=True)
    assert np.array_equal(_values(view), _host(d2, first))
    assert (wide[:, :, :3] == 7).all() and (wide[:, :, 3 + cols :] == 7).all()


def test_cpu_tensors_leave_the_kernel_counter_alone(ops):
    launches = goldilocks_combine.launches
    diag = _diagonals(5, 8, 6)
    out = goldilocks_combine(ops, diag, torch.empty((4, 5, 8), dtype=torch.uint16))
    assert np.array_equal(_values(out), _host(diag))
    F = gt.GF(P)
    with gt.default_device("cpu"):
        a, b = F.Random((3, 7), seed=1), F.Random((7, 4), seed=2)
        c = a @ b
    A, B = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
    assert np.array_equal(np.asarray(c, dtype=object), A.dot(B) % P)
    assert goldilocks_combine.launches == launches


@pytest.mark.parametrize("shape", [(2, 0, 3), (0, 4, 3), (2, 4, 0)])
def test_goldilocks_matmul_with_an_empty_axis(shape):
    """K = 0 gives the empty sum, 0, as on the generic path; M or N = 0 an
    empty product."""
    M, K, N = shape
    F = gt.GF(P)
    with gt.default_device("cpu"):
        c = F(np.zeros((M, K), dtype=np.int64)) @ F(np.ones((K, N), dtype=np.int64))
    assert c.shape == (M, N) and not np.asarray(c, dtype=np.int64).any()


@pytest.mark.parametrize(
    "case",
    ["dtype", "diagonals", "rows", "out_dtype", "out_cols"],
)
def test_combine_checks_raise(ops, case):
    diag = _diagonals(4, 6, 7)
    out = torch.empty((4, 4, 6), dtype=torch.uint16)
    d, o = {
        "dtype": (diag.to(torch.int64), out),
        "diagonals": (diag[:18], out),
        "rows": (diag, out[:, :3]),
        "out_dtype": (diag, out.to(torch.int32)),
        "out_cols": (diag, out[:, :, :5]),
    }[case]
    with pytest.raises(ValueError):
        goldilocks_combine(ops, d, o)


def test_chunk_width_counts_the_diagonals_on_cuda_only():
    """On the card a chunk holds the int32 diagonals and B's digit planes;
    the plain version's int64 columns and Barrett limbs still size the
    CPU's chunks."""
    assert _limb_matmul._gold_bytes_per_column(4096, 4096) == 4 * S * 4096 + 80 * 4096
    cpu = _limb_matmul._bytes_per_column(4096, S, _limb_matmul._GOLD_W, 4)
    assert cpu > 5 * _limb_matmul._gold_bytes_per_column(4096, 4096)


@pytest.mark.parametrize("M,kb", [(0, 4096), (64, 4096), (4096, 4096), (16384, 4096), (64, 13314), (1, 1)])
def test_chunk_columns_fit_the_budget(M, kb):
    """A chunk is a multiple of 32 columns, 32 at least, and the widest
    such that its bytes (B's planes included: a few rows and a long K give
    narrow chunks) fit ``_CHUNK_BYTES``."""
    per_col = _limb_matmul._gold_bytes_per_column(M, kb)
    nc = _limb_matmul._chunk_columns(per_col)
    assert nc % 32 == 0 and nc >= 32
    assert nc == 32 or nc * per_col <= _limb_matmul._CHUNK_BYTES < (nc + 32) * per_col
    assert _limb_matmul._chunk_columns(0) == _limb_matmul._chunk_columns(1)


# ----------------------------------------------------------------------
# csrc/gold_combine.cu's arithmetic in Python ints, 64-bit words wrapping
# ----------------------------------------------------------------------


def _pow2_mod_p(e):
    """pow2_mod_p: 2^e mod p by doubling, as the kernel's constants."""
    x = 1
    for _ in range(e):
        y = (x << 1) & M64
        if x >> 63:
            y += EPS
            assert y <= M64
        if y >= P:
            y -= P
        x = y
    return x


def _mac(lo, hi, d, c):
    """(hi:lo) += d c from two 32 x 32 -> 64-bit products."""
    c0, c1 = c & EPS, c >> 32
    p0, p1 = d * c0, d * c1
    assert p0 <= M64 and p1 <= M64
    t = (p0 + (p1 << 32)) & M64
    t_hi = (p1 >> 32) + (t < p0)
    lo = (lo + t) & M64
    hi = (hi + t_hi + (lo < t)) & M64
    return lo, hi


def _reduce128(lo, hi):
    hi_hi, hi_lo = hi >> 32, hi & EPS
    t0 = (lo - hi_hi) & M64
    if lo < hi_hi:
        assert t0 >= EPS  # cannot underflow
        t0 -= EPS
    t1 = hi_lo * EPS
    assert t1 <= M64
    t2 = (t0 + t1) & M64
    if t2 < t1:
        t2 += EPS
        assert t2 <= M64  # no second carry
    return t2 - P if t2 >= P else t2


def _kernel_model(d, prev=0):
    lo, hi = prev, 0
    for s in range(S):
        lo, hi = _mac(lo, hi, d[s], _pow2_mod_p(7 * s))
    assert (hi << 64) + lo == prev + sum(d[s] * pow(2, 7 * s, P) for s in range(S))  # the sum never wraps
    return _reduce128(lo, hi)


def test_kernel_constants_are_the_powers_of_two():
    assert [_pow2_mod_p(7 * s) for s in range(S)] == [pow(2, 7 * s, P) for s in range(S)]
    assert _pow2_mod_p(70) == 0x3FFFFFFFC0 and _pow2_mod_p(126) == 0xFFFFFFFEC0000001  # the source's asserts


@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_matches_exact_residues(seed):
    """Unsigned 32-bit diagonals (the kernel reads any bit pattern so), with
    and without a canonical residue accumulated, and the extremes."""
    rng = np.random.default_rng(seed)
    cases = [([0] * S, 0), ([2**32 - 1] * S, P - 1), (_highs(), 0), (_highs(), P - 1), ([1] + [0] * 18, P - 1)]
    for _ in range(200):
        d = [int(v) for v in rng.integers(0, 2**32, S)]
        cases.append((d, int(rng.integers(0, P, dtype=np.uint64)) if rng.random() < 0.5 else 0))
    for d, prev in cases:
        assert _kernel_model(d, prev) == (prev + sum(v << (7 * s) for s, v in enumerate(d))) % P


def test_kernel_reduction_of_any_128_bit_value():
    """reduce128 on random 128-bit values and on the borrow and carry edges."""
    rng = np.random.default_rng(9)
    values = [0, 1, P - 1, P, 2**64 - 1, 2**64, 2**96 - 1, 2**96, 2**128 - 1, (2**32 - 1) << 64, 5 + (31 << 96)]
    values += [int.from_bytes(rng.bytes(16), "little") for _ in range(500)]
    values += [int(v) + (int(h) << 96) for v, h in zip(rng.integers(0, 32, 50), rng.integers(1, 2**32, 50))]
    for x in values:
        assert _reduce128(x & M64, x >> 64) == x % P
