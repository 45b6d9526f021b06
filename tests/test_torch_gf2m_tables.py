"""Kernels K8 (GF(2^m <= 8) multiply) and K8-A (GF(2^m) reciprocal and
powers) of the torch port read the field's tables, ``pack_tables``' layout
from ``gf2m_packed_tables``; here their index arithmetic is emulated in
torch on those tensors, on the CPU, and held against the plain versions and
the JAX package:

- K8: LOG (byte 0) and EXP (byte 1) of the byte rows, EXP[LOG a + LOG b]
  masked where a or b is 0, against ``gf2m_multiply_swar_plain`` and the JAX
  ``multiply`` for m = 2..8 over every pair;
- K8-A: INV (byte 3, or the uint16 INV segment) with 0 masked; the
  exponent's reduction to e', LOG a * e' brought below 2^m - 1 by two folds
  and a conditional subtract, EXP (byte 1, or the reduced uint16 EXP), the
  masks for e' = 0 and a = 0; against ``gf2m_power_plain`` and the JAX
  ``reciprocal`` and ``power`` for m = 2..16 (every element for m <= 10, a
  seeded sample above), the field's default f and a second one;
- the strided walk of both kernels (``csrc/lookup.cuh``'s Axes, Strides and
  Coord, and K8's two segments a run of 16) on the RS decoder's layouts,
  and ``_merged_axes`` against ``torch.broadcast_tensors``;
- the table cache: one tensor per (m, f, device), the one that
  ``BinaryExtOps.packed_tables`` serves.

Inputs are made with numpy from a seed; the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.ops._kernels import get_ops as jax_get_ops
from galois_tpu_torch.ops._elementwise import _merged_axes, _strided, gf2m_multiply_swar_plain, gf2m_power_plain
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.fields._tables import build_exp_log
from galois_tpu_torch.ops._lookup import gf2m_packed_tables

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _polys(m):
    """The field's default f and, where there is one, another irreducible f."""
    f = gj.GF(2**m)._meta.irreducible_poly_int
    other = int(gj.irreducible_poly(2, m, method="max"))
    return [f] if other == f else [f, other]


def _jax_ops(m, f):
    meta = gj.GF(2**m, irreducible_poly=f)._meta
    return jax_get_ops(meta, "jit-calculate"), meta.internal_dtype


def _elements(m, rng):
    if m <= 10:
        return np.arange(2**m, dtype=np.int64)
    a = rng.integers(0, 2**m, 2051)
    a[:3] = [0, 1, 2**m - 1]
    return a


def _round8(x):
    return -(-x // 8) * 8


class _Tab:
    """pack_tables' tensor of GF(2)[x]/f read at the kernels' indices:
    the byte rows (m <= 8: LOG byte 0, EXP byte 1, INV byte 3) or the
    uint16 segments (LOG at 0, the reduced EXP at q8, INV at q8 + e8)."""

    def __init__(self, m, f):
        self.m, self.q = m, 2**m
        tab = gf2m_packed_tables(m, f, CPU)
        if m <= 8:
            assert tab.dtype == torch.int32 and tab.numel() == 2 * (self.q - 1)
            self.rows = tab.view(torch.uint8).reshape(-1, 4).to(torch.int64)
        else:
            self.u16 = tab.to(torch.int64) & 0xFFFF
            self.q8, self.e8 = _round8(self.q), _round8(self.q - 1)

    def log(self, x):
        return self.rows[x, 0] if self.m <= 8 else self.u16[x]

    def exp(self, s):  # s < 2(q - 1) on the byte rows, s < q - 1 on the reduced EXP
        if self.m <= 8:
            return self.rows[s, 1]
        assert int(s.max()) < self.q - 1
        return self.u16[self.q8 + s]

    def inv(self, x):
        return self.rows[x, 3] if self.m <= 8 else self.u16[self.q8 + self.e8 + x]


def _fold_mod(x, m):
    """x mod 2^m - 1 for x < 2^(2m), as the kernel: two folds, then one
    conditional subtract; the result must lie below 2^m - 1."""
    q1 = 2**m - 1
    x = (x & q1) + (x >> m)
    x = (x & q1) + (x >> m)
    x = torch.where(x >= q1, x - q1, x)
    assert int(x.max()) < q1 and int(x.min()) >= 0
    return x


def _reduce_exponent(e, m, nbits):
    """e' in [0, 2^m - 1] from the low nbits bits of the int64 e, read as
    unsigned 64-bit, as the kernel's reduce_exponent."""
    v = e.numpy().astype(np.uint64)
    if nbits < 64:
        v = v & np.uint64((1 << nbits) - 1)
    q1 = np.uint64(2**m - 1)
    red = np.where(v == 0, np.uint64(0), (v - np.uint64(1)) % q1 + np.uint64(1))
    return torch.from_numpy(red.astype(np.int64))


def k8_emulated(a, b, m, f):
    tab = _Tab(m, f)
    a, b = (x.to(torch.int64) for x in torch.broadcast_tensors(a, b))
    r = tab.exp(tab.log(a) + tab.log(b))
    return torch.where((a == 0) | (b == 0), 0, r).to(torch.uint8)


def k8a_emulated(a, e, m, f, nbits=0):
    tab, dt = _Tab(m, f), torch.uint8 if m <= 8 else torch.int64
    if e is None:
        x = a.to(torch.int64)
        return torch.where(x == 0, 0, tab.inv(x)).to(dt)
    x, e = torch.broadcast_tensors(a.to(torch.int64), e)
    ev = _reduce_exponent(e.contiguous(), m, nbits)
    r = tab.exp(_fold_mod(tab.log(x) * ev, m))
    return torch.where(ev == 0, 1, torch.where(x == 0, 0, r)).to(dt)


@pytest.mark.parametrize("m", range(2, 9))
def test_k8_table_form_matches_plain_and_jax(m):
    a = torch.arange(2**m, dtype=torch.uint8)
    x, y = a[:, None], a[None, :]
    for f in _polys(m):
        got = k8_emulated(x, y, m, f)
        assert torch.equal(got, gf2m_multiply_swar_plain(x, y, m, f))
        jops, jdt = _jax_ops(m, f)
        xx, yy = np.broadcast_arrays(x.numpy().astype(jdt), y.numpy().astype(jdt))
        assert np.array_equal(got.numpy(), np.asarray(jops.multiply(xx, yy)).astype(np.uint8))


@pytest.mark.parametrize("m", range(2, 17))
def test_k8a_reciprocal_table_form_matches_plain_and_jax(m):
    a = _elements(m, np.random.default_rng(m))
    dt = torch.uint8 if m <= 8 else torch.int64
    for f in _polys(m):
        got = k8a_emulated(torch.from_numpy(a).to(dt), None, m, f)
        assert int(got[a == 0].sum()) == 0  # 1 / 0 is 0, though pack_tables' INV[0] is 1
        assert torch.equal(got, gf2m_power_plain(torch.from_numpy(a).to(dt), None, m, f))
        jops, jdt = _jax_ops(m, f)
        assert np.array_equal(got.to(torch.int64).numpy(), np.asarray(jops.reciprocal(a.astype(jdt))).astype(np.int64))


@pytest.mark.parametrize("m", range(2, 17))
def test_k8a_power_table_form_matches_plain_and_jax(m):
    rng = np.random.default_rng(200 + m)
    a = _elements(m, rng)
    q, dt = 2**m, torch.uint8 if m <= 8 else torch.int64
    at = torch.from_numpy(a).to(dt)
    edges = torch.tensor([0, 1, q - 2, q - 1, q, 2 * (q - 1), 2**63 - 1, -1, -(2**63)])
    for f in _polys(m):
        e = torch.from_numpy(rng.integers(-(2**62), 2**62, a.shape))
        for nbits in (m, 64):
            got = k8a_emulated(at, e, m, f, nbits)
            assert torch.equal(got, gf2m_power_plain(at, e, m, f, nbits)), nbits
        # the edges against every base, by the plain ladder
        k = min(a.size, 256)
        for nbits in (0, m, 64):
            got = k8a_emulated(at[:k, None], edges[None, :], m, f, nbits)
            assert torch.equal(got, gf2m_power_plain(at[:k, None], edges[None, :], m, f, nbits)), nbits
    jops, jdt = _jax_ops(m, f)  # the last f
    e40 = rng.integers(0, 2**40, a.shape)
    e40[:4] = [0, q - 1, q, 2 * (q - 1)]
    got = k8a_emulated(at, torch.from_numpy(e40), m, f, 40)
    assert np.array_equal(got.to(torch.int64).numpy(), np.asarray(jops.power(a.astype(jdt), e40)).astype(np.int64))


@pytest.mark.parametrize("m", range(2, 17))
def test_fold_reduction_covers_every_product(m):
    """LOG a * e' < 2^(2m): two folds and a conditional subtract equal the
    remainder, at the extremes and on a sample (every pair for m <= 8)."""
    q1 = 2**m - 1
    if m <= 8:
        lg, ev = torch.meshgrid(torch.arange(q1), torch.arange(q1 + 1), indexing="ij")
    else:
        rng = np.random.default_rng(m)
        lg = torch.from_numpy(np.concatenate([[0, q1 - 1, q1 - 1, 1], rng.integers(0, q1, 20000)]))
        ev = torch.from_numpy(np.concatenate([[q1, q1, q1 - 1, q1], rng.integers(0, q1 + 1, 20000)]))
    p = lg * ev
    assert int(p.max()) < 2 ** (2 * m) <= 2**32
    assert torch.equal(_fold_mod(p, m), p % q1)


def test_exp_log_serve_any_irreducible_f():
    """The tables come from (m, f) alone, through the field factory and
    ``build_exp_log``: a primitive element is found when x is not one (the
    AES polynomial), and a reducible f, or one of another degree, is
    refused."""
    for m, f in ((8, 0x11B), (8, 0x11D), (4, 0b11111), (9, 529)):
        tab = _Tab(m, f)
        q = 2**m
        exp = tab.exp(torch.arange(q - 1))
        log = tab.log(exp)
        assert sorted(exp.tolist()) == list(range(1, q)) and torch.equal(log, torch.arange(q - 1))
        exp_b, log_b = build_exp_log(gt.GF(q, irreducible_poly=f)._meta)
        assert np.array_equal(exp.numpy(), exp_b[: q - 1]) and np.array_equal(log.numpy(), log_b[exp_b[: q - 1]])
    with pytest.raises(ValueError):
        gf2m_packed_tables(8, 0x101, CPU)  # x^8 + 1 = (x + 1)^8, reducible
    with pytest.raises(ValueError):
        gf2m_packed_tables(8, 0x1D, CPU)  # not of degree 8


@pytest.mark.parametrize("m", [4, 8, 9, 16])
def test_binary_ext_ops_serve_the_one_table_cache(m):
    F = gt.GF(2**m)
    ops = get_ops(F._meta, "jit-calculate")
    assert ops.packed_tables(CPU) is gf2m_packed_tables(m, F._meta.irreducible_poly_int, CPU)
    assert ops.packed_tables("cpu") is ops.packed_tables(CPU)


@pytest.mark.parametrize("m", [4, 8, 9, 16])
def test_lookup_mode_reads_the_same_table(m):
    """The field in lookup mode hands K3-K6 the tensor that K8, K8-A and
    K8-B read: one table per field and device."""
    F = gt.GF(2**m)
    packed = get_ops(F._meta, "jit-lookup")._tables.packed(CPU)
    assert packed is gf2m_packed_tables(m, F._meta.irreducible_poly_int, CPU)


# ----------------------------------------------------------------------
# The strided walk of K8 and K8-A
# ----------------------------------------------------------------------

def _decoder_layouts(B=37):
    """(a, b) of K8's launches in the RS decoder at a small B, and the
    layouts around them."""
    a = torch.arange(B * 255 + 300) % 251
    return {
        "outer product (B, 1, 33) x (B, 32, 1)": (a[: B * 33].reshape(B, 1, 33), a[: B * 32].reshape(B, 32, 1)),
        "derivative (B, 32) x (1, 32)": (a[: B * 32].reshape(B, 32), a[:32].reshape(1, 32)),
        "Forney (B, 255) x (1, 255)": (a[: B * 255].reshape(B, 255), a[7:262].reshape(1, 255)),
        "Forney (B, 255) x (B, 255)": (a[: B * 255].reshape(B, 255), a[1 : B * 255 + 1].reshape(B, 255)),
        "column (B, 33) x (B, 1)": (a[: B * 33].reshape(B, 33), a[:B].reshape(B, 1)),
        "Gamma's 0-D g against (B, 33)": (a[5], a[: B * 33].reshape(B, 33)),
        "transposed": (a[:200].reshape(10, 20).t(), a[:200].reshape(20, 10)),
        "four axes": (a[:16].reshape(2, 1, 8, 1)[:, :, ::2], a[:15].reshape(1, 3, 1, 5)),
    }


@pytest.mark.parametrize("layout", list(_decoder_layouts()))
def test_merged_axes_read_what_broadcast_tensors_give(layout):
    x, y = _decoder_layouts()[layout]
    shape = torch.broadcast_shapes(x.shape, y.shape)
    views = [v.expand(shape) for v in (x, y)]
    merged = _merged_axes(shape, *(v.stride() for v in views))
    assert (merged is None) == (layout == "four axes")
    (xs, ys), n1, n2, (sx, sy) = _strided(shape, (x, y))
    n0 = int(np.prod(shape)) // (n1 * n2)
    for v, st, want in zip((xs, ys), (sx, sy), torch.broadcast_tensors(x, y)):
        got = torch.as_strided(v, (n0, n1, n2), st).reshape(-1)
        assert torch.equal(got, want.reshape(-1))
    if layout.startswith("outer"):
        assert (n0, n1, n2) == (37, 32, 33) and sx == (33, 0, 1) and sy == (32, 1, 0)


def _walk(n, n1, n2, strides, threads, run):
    """The offsets at each element as the kernels walk them: a thread starts
    at element run * tid by division, then steps run * threads elements by
    the step's digits and the wraps' offsets (lookup.cuh: make_axes,
    make_strides, Coord.step, advance); within a run of K8, the elements
    before the end of the inner axis (w) from the run's first offset, the
    rest from the next row's (c1 + 1, 0), or (c0 + 1, 0, 0), by the inner
    stride. Returns the offset of every element, per operand."""
    step = run * threads
    k1, k2, k0 = (step // n2) % n1, step % n2, step // (n1 * n2)
    out = [np.full(n, -1, dtype=np.int64) for _ in strides]
    for tid in range(threads):
        i = run * tid
        if i >= n:
            continue
        c2, t = i % n2, i // n2
        c1 = t % n1
        offs = [(i // (n1 * n2)) * s0 + c1 * s1 + c2 * s2 for s0, s1, s2 in strides]
        while i + run <= n:
            w = min(n2 - c2, run)
            for k, (s0, s1, s2) in enumerate(strides):
                nxt = offs[k] + s1 - c2 * s2 + (s0 - n1 * s1 if c1 + 1 == n1 else 0)
                for j in range(run):
                    out[k][i + j] = offs[k] + j * s2 if j < w else nxt + (j - w) * s2
            i += step
            c2 += k2
            carry2 = c2 >= n2
            c2 -= n2 if carry2 else 0
            c1 += k1 + carry2
            carry1 = c1 >= n1
            c1 -= n1 if carry1 else 0
            for k, (s0, s1, s2) in enumerate(strides):
                offs[k] += k0 * s0 + k1 * s1 + k2 * s2 + (s1 - n2 * s2 if carry2 else 0) + (s0 - n1 * s1 if carry1 else 0)
    return out


@pytest.mark.parametrize("layout", ["outer product (B, 1, 33) x (B, 32, 1)", "derivative (B, 32) x (1, 32)",
                                    "Forney (B, 255) x (1, 255)", "column (B, 33) x (B, 1)"])
@pytest.mark.parametrize("threads, run", [(7, 16), (64, 16), (5, 1), (96, 1)])
def test_strided_walk_reaches_every_element(layout, threads, run):
    """K8's runs of 16 (n2 >= 16: at most one end of the inner axis a run)
    and K8-A's single elements, over odd grids, give each operand's offset
    at every element of the full runs."""
    x, y = _decoder_layouts()[layout]
    shape = torch.broadcast_shapes(x.shape, y.shape)
    (xs, ys), n1, n2, strides = _strided(shape, (x, y))
    n = int(np.prod(shape))
    full = n - n % run
    offs = _walk(n, n1, n2, strides, threads, run)
    n0 = n // (n1 * n2)
    for st, got in zip(strides, offs):
        want = torch.as_strided(torch.arange(10**7), (n0, n1, n2), st).reshape(-1).numpy()
        assert np.array_equal(got[:full], want[:full])
