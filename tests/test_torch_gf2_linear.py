"""Kernel K15 of the torch port: GF(2^m) products with a constant matrix as
one GF(2)-linear map (``ops/_gf2_linear.py``, ``csrc/gf2_linear.cu``).

The map T of ``linear_map`` times the bits of X, and the wrapper's plain
version on its packed layout, against ``binary_matmul`` and the JAX
package's product, for GF(2^8) under CCSDS's f = 0x187 and the default f,
GF(2^9) and GF(2^16), K = 1 and N = 1 among the shapes; ``pack_map`` and
``unpack_map`` as inverses for every m; a numpy model of the kernel, cell
for cell (bit strings, A fragments, the mma.m16n8k32 fragment layouts, the
epilogue's shuffles, the extraction), against the plain version; the
decoder's routing (every constant product of RS(255,223), with and without
erasures, and of BCH(511,493) through the wrapper, none through
``binary_matmul``; a constant past the byte bound on bit planes; the
public matmul untouched); and the ``gf.binary_matmul`` spans. Inputs are
made with numpy from a seed; the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch import _tracing
from galois_tpu_torch.codes import _decoder
from galois_tpu_torch.ops import _binary_matmul, _gf2_linear
from galois_tpu_torch.ops._gf2_linear import (
    NT,
    geometry,
    gf2_linear,
    gf2_linear_plain,
    linear_map,
    pack_map,
    unpack_map,
)

FIELDS = {"ccsds": (2**8, 0x187), "gf256": (2**8, None), "gf512": (2**9, None), "gf65536": (2**16, None)}
SHAPES = [(5, 1, 1), (3, 1, 7), (6, 9, 1), (4, 33, 17)]  # (rows, K, N)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _field(pkg, name):
    q, f = FIELDS[name]
    return pkg.GF(q) if f is None else pkg.GF(q, irreducible_poly=f)


def _operands(name, shape, seed):
    q = FIELDS[name][0]
    rows, k, n = shape
    rng = np.random.default_rng(seed)
    X, M = rng.integers(0, q, (rows, k)), rng.integers(0, q, (k, n))
    X[0, 0], M[-1, -1] = q - 1, 0  # the largest element and a zero
    return X, M


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_map_matches_binary_matmul_and_jax(name, shape):
    F = _field(gt, name)
    meta, m = F._meta, F._meta.degree
    X, M = _operands(name, shape, seed=sum(shape) + len(name))
    x, Mt = (torch.from_numpy(v).to(meta.torch_dtype) for v in (X, M))
    T = linear_map(meta, M)
    assert T.shape == (shape[1] * m, shape[2] * m) and T.dtype == np.int8 and set(np.unique(T)) <= {0, 1}
    bits = (X[..., None] >> np.arange(m)) & 1
    direct = ((bits.reshape(shape[0], -1) @ T.astype(np.int64)) & 1).reshape(shape[0], shape[2], m)
    direct = (direct << np.arange(m)).sum(-1)
    via_wrapper = gf2_linear(x, torch.from_numpy(pack_map(T, m)), m, shape[2])
    assert via_wrapper.dtype == meta.torch_dtype and via_wrapper.shape == (shape[0], shape[2])
    planes = _binary_matmul.binary_matmul(meta, x, Mt)
    jax_out = np.asarray(_field(gj, name)(X) @ _field(gj, name)(M)).astype(np.int64)
    for got in (direct, via_wrapper.numpy().astype(np.int64), planes.numpy().astype(np.int64)):
        assert np.array_equal(got, jax_out)


@pytest.mark.parametrize("m", range(2, 17))
def test_pack_and_unpack_are_inverse(m):
    rng = np.random.default_rng(m)
    k, n = 1 + 3 * m % 11, 1 + 7 * m % 13
    T = rng.integers(0, 2, (k * m, n * m)).astype(np.int8)
    frags = pack_map(T, m)
    ks, groups = geometry(k, n, m)
    assert frags.shape == (groups, ks, NT, 32, 8) and frags.flags.c_contiguous
    full = unpack_map(torch.from_numpy(frags)).numpy()
    assert full.shape == (32 * ks, 8 * NT * groups) and np.array_equal(full[: k * m, : n * m], T)
    assert not full[k * m :].any() and not full[:, n * m :].any()  # the padding is zero


def _spread4(v):
    return ((v & 15) * 0x00204081) & 0x01010101


def _bytes(word):
    return [(int(word) >> (8 * j)) & 0xFF for j in range(4)]


def _kernel_model(x: np.ndarray, frags: np.ndarray, m: int, n: int, warps: int) -> np.ndarray:
    """``csrc/gf2_linear.cu``'s indexing, cell for cell, a CTA of ``warps``
    warps at a time: the rows' bit strings (bytes for m = 8, else each element ORed
    into its one or two words), each lane's A fragments by ``spread4``, B
    fragments as the lane reads them, mma.m16n8k32 by its PTX fragment
    layouts, the epilogue's parities, shuffles and byte stores, and the
    extraction of the output elements."""
    rows, k = x.shape
    groups, ks = frags.shape[:2]
    xstride, ostride = ks | 1, ((groups * NT + 6) // 4 | 1) * 4
    bm, mask = 32 * warps, (1 << m) - 1
    fl = frags.reshape(groups, ks, NT, 32, 8).astype(np.int64)
    out = np.zeros((rows, n), dtype=np.int64)
    for row0 in range(0, rows, bm):
        xs = np.zeros(bm * xstride, dtype=np.int64)  # 1. bit strings
        for r in range(min(bm, rows - row0)):
            for e in range(k):
                v, bit = int(x[row0 + r, e]) & mask, e * m
                if m == 8:  # byte e of the row's words
                    xs[r * xstride + e // 4] |= v << (8 * (e % 4))
                    continue
                off = bit & 31
                xs[r * xstride + (bit >> 5)] |= (v << off) & 0xFFFFFFFF
                if off + m > 32:
                    xs[r * xstride + (bit >> 5) + 1] |= v >> (32 - off)
        os_ = np.zeros(bm * ostride, dtype=np.int64)
        for warp in range(warps):  # 2. the products
            for grp in range(groups):
                acc = np.zeros((2, NT, 32, 4), dtype=np.int64)
                for s in range(ks):
                    A = np.zeros((2, 16, 32), dtype=np.int64)
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        for i in range(2):
                            lo = xs[(warp * 32 + g + 16 * i) * xstride + s]
                            hi = xs[(warp * 32 + g + 16 * i + 8) * xstride + s]
                            regs = [_spread4(lo >> (4 * t)), _spread4(hi >> (4 * t)),
                                    _spread4(lo >> (16 + 4 * t)), _spread4(hi >> (16 + 4 * t))]
                            for reg, (row, col) in zip(regs, [(g, 4 * t), (g + 8, 4 * t), (g, 16 + 4 * t),
                                                              (g + 8, 16 + 4 * t)]):
                                A[i, row, col : col + 4] = _bytes(reg)
                    for j in range(NT):
                        Bm = np.zeros((32, 8), dtype=np.int64)
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            b = fl[grp, s, j, lane]
                            Bm[4 * t : 4 * t + 4, g], Bm[16 + 4 * t : 20 + 4 * t, g] = b[:4], b[4:]
                        for i in range(2):
                            C = A[i] @ Bm
                            for lane in range(32):
                                g, t = lane >> 2, lane & 3
                                acc[i, j, lane] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
                for i in range(2):
                    for j in range(0, NT, 2):
                        v = np.zeros(32, dtype=np.int64)
                        for lane in range(32):
                            t = lane & 3
                            for jj, shift in ((j, 0), (j + 1, 16)):
                                c = acc[i, jj, lane] & 1
                                v[lane] |= ((c[0] | c[1] << 1 | c[2] << 8 | c[3] << 9) << (2 * t)) << shift
                        v = v | v[np.arange(32) ^ 1]
                        v = v | v[np.arange(32) ^ 2]
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            row = warp * 32 + g + 8 * (t & 1) + 16 * i
                            os_[row * ostride + grp * NT + j + (t >> 1)] = (v[lane] >> (8 * t)) & 0xFF
        for r in range(min(bm, rows - row0)):  # 3. the elements
            for c in range(n):
                bit = c * m
                p = r * ostride + (bit >> 3)
                w = os_[p] | os_[p + 1] << 8 | os_[p + 2] << 16
                out[row0 + r, c] = (w >> (bit & 7)) & mask
    return out


@pytest.mark.parametrize(["q", "rows", "k", "n", "warps"], [
    (2**8, 45, 5, 9, 1),  # ragged rows: the second CTA holds 13
    (2**8, 64, 2, 3, 2),
    (2**9, 33, 4, 5, 1),  # GF(2^9): elements straddle the words and the output bytes
    (2**5, 32, 7, 3, 1),
    (2**16, 20, 3, 5, 1),
])
def test_kernel_model_matches_plain(q, rows, k, n, warps):
    F = gt.GF(q)
    meta, m = F._meta, F._meta.degree
    rng = np.random.default_rng(rows * k + n)
    X, M = rng.integers(0, q, (rows, k)), rng.integers(0, q, (k, n))
    frags = pack_map(linear_map(meta, M), m)
    want = gf2_linear_plain(torch.from_numpy(X).to(meta.torch_dtype), torch.from_numpy(frags), m, n)
    got = _kernel_model(X, frags, m, n, warps)
    assert np.array_equal(got, want.numpy().astype(np.int64))
    assert np.array_equal(got, np.asarray(F(X) @ F(M)).astype(np.int64))


CODES = {"rs255": lambda: gt.ReedSolomon(255, 223), "bch511": lambda: gt.BCH(511, 493)}


def _received(code, erasures: bool, rows: int = 6):
    rng = np.random.default_rng(23)
    q = code.field.order
    msg = rng.integers(0, q, (rows, code.k))
    cw = np.asarray(code.encode(code.field.from_numpy(msg, device="cpu"))).astype(np.int64)
    for i in range(rows):
        pos = rng.choice(code.n, size=min(i, code.t), replace=False)
        cw[i, pos] = (cw[i, pos] + rng.integers(1, q, pos.size)) % q
    era = None
    if erasures:
        era = np.zeros(cw.shape, dtype=bool)
        era[:, [2, 50]] = True
    return msg, code.field.from_numpy(cw, device="cpu"), era


def _recording(monkeypatch):
    calls = []
    for mod, name in ((_decoder, "gf2_linear"), (_decoder, "binary_matmul")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name: (calls.append(name), real(*a))[1])
    return calls


@pytest.mark.parametrize(["name", "erasures", "products"],
                         [("rs255", False, 4), ("rs255", True, 5), ("bch511", False, 4)])
def test_decoder_products_take_the_map(monkeypatch, name, erasures, products):
    code = CODES[name]()
    msg, word, era = _received(code, erasures)
    calls = _recording(monkeypatch)
    out, n_errors = code.decode(word, erasures=era, errors=True)
    assert calls == ["gf2_linear"] * products
    assert np.array_equal(np.asarray(out), msg) and np.array_equal(n_errors, [min(i, code.t) for i in range(6)])


def test_constant_past_the_bound_keeps_bit_planes(monkeypatch):
    """RS(255,223) with the bound between the maps' sizes: Vinv_T's map
    (92160 bytes) is made, W's, CH_T's and CHn_T's (512-576 KB) are not and
    their products run on bit planes; the decode is the same."""
    rs = gt.ReedSolomon(255, 223)
    meta = rs.field._meta
    monkeypatch.setattr(_gf2_linear, "MAX_MAP_BYTES", 300_000)
    dec = _decoder._Decoder(meta, rs.field._mode, rs.n, rs.n, rs.d, rs.c, int(rs.alpha), True)
    assert sorted(dec.maps) == ["T_Vinv_T"]
    msg, word, era = _received(rs, True)
    era_t = torch.from_numpy(era)
    calls = _recording(monkeypatch)
    out, cnt = dec(word._data, era_t)
    assert calls == ["binary_matmul", "gf2_linear", "binary_matmul", "binary_matmul", "binary_matmul"]
    monkeypatch.undo()
    full = _decoder._Decoder(meta, rs.field._mode, rs.n, rs.n, rs.d, rs.c, int(rs.alpha), True)
    assert sorted(full.maps) == ["T_CH_T", "T_CHn_T", "T_Vinv_T", "T_W"]
    want_out, want_cnt = full(word._data, era_t)
    assert torch.equal(out, want_out) and torch.equal(cnt, want_cnt)


def test_public_matmul_keeps_binary_matmul(monkeypatch):
    F = gt.GF(2**8)
    a, b = F.Random((5, 7), seed=3, device="cpu"), F.Random((7, 4), seed=4, device="cpu")
    calls = []
    real = _binary_matmul.binary_matmul
    monkeypatch.setattr(_binary_matmul, "binary_matmul", lambda *x: (calls.append(1), real(*x))[1])
    monkeypatch.setattr(_gf2_linear, "gf2_linear", lambda *x: pytest.fail("the public matmul took K15"))
    got = np.asarray(a @ b)
    assert calls == [1]
    assert np.array_equal(got, np.asarray(gj.GF(2**8)(np.asarray(a)) @ gj.GF(2**8)(np.asarray(b))))


@pytest.mark.parametrize("name", sorted(CODES))
def test_decoder_products_record_binary_matmul_spans(name):
    code = CODES[name]()
    _, word, _ = _received(code, False)
    _tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        code.decode(word, errors=True)
    recs = _tracing.spans()
    _tracing.clear()
    by_index = {s.index: s for s in recs}
    parents = [by_index[s.parent].name for s in recs if s.name == "gf.binary_matmul"]
    assert parents == ["gf.decode.syndromes", "gf.decode.chien", "gf.decode.forney", "gf.decode.forney"]


def test_wrapper_checks_its_operands():
    meta = gt.GF(2**8)._meta
    frags = torch.from_numpy(pack_map(linear_map(meta, np.ones((5, 2), dtype=np.int64)), 8))
    x = torch.zeros((4, 5), dtype=torch.uint8)
    assert gf2_linear(x, frags, 8, 2).shape == (4, 2)
    assert gf2_linear(x[:0], frags, 8, 2).shape == (0, 2)
    with pytest.raises(ValueError):
        gf2_linear(x.to(torch.int64), frags, 8, 2)  # GF(2^8) storage is uint8
    with pytest.raises(ValueError):
        gf2_linear(x[:, :3], frags, 8, 2)  # K m fills fewer 32-bit k-steps than the map's
    with pytest.raises(ValueError):
        gf2_linear(x, frags, 8, 9)  # N m fills more passes than the map's


@pytest.mark.parametrize("name", ["ccsds", "gf512", "gf65536"])
def test_plain_row_chunks_match_one_pass(monkeypatch, name):
    """The plain version's row chunks (here of 1 to 3 rows and a ragged
    last chunk) give what one pass over all rows gives."""
    F = _field(gt, name)
    meta, m = F._meta, F._meta.degree
    X, M = _operands(name, (37, 11, 6), seed=len(name))
    x = torch.from_numpy(X).to(meta.torch_dtype)
    frags = torch.from_numpy(pack_map(linear_map(meta, M), m))
    whole = gf2_linear_plain(x, frags, m, 6)
    for elems in (11 * m, 2 * 11 * m, 3 * 11 * m):
        monkeypatch.setattr(_gf2_linear, "_CHUNK_ELEMS", elems)
        assert torch.equal(gf2_linear_plain(x, frags, m, 6), whole)
    jax_out = np.asarray(_field(gj, name)(X) @ _field(gj, name)(M)).astype(np.int64)
    assert np.array_equal(whole.numpy().astype(np.int64), jax_out)


def test_plain_map_is_unpacked_once_per_map():
    """The plain version unpacks a packed map once, unpacks it again after
    an in-place change, and forgets it when the map is freed."""
    meta = gt.GF(2**8)._meta
    frags = torch.from_numpy(pack_map(linear_map(meta, np.arange(1, 13).reshape(4, 3)), 8))
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (9, 4))).to(torch.uint8)
    first = _gf2_linear._plain_map(frags)
    assert _gf2_linear._plain_map(frags) is first and first.dtype == torch.float32
    assert torch.equal(first, unpack_map(frags).to(torch.float32))
    before = gf2_linear_plain(x, frags, 8, 3)
    frags.zero_()
    assert _gf2_linear._plain_map(frags) is not first and not gf2_linear_plain(x, frags, 8, 3).any()
    assert before.any()
    key = id(frags)
    del frags
    assert key not in _gf2_linear._plain_maps
