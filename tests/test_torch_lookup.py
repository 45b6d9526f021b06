"""Lookup mode and small odd extension fields of the torch port against the
JAX package.

The same inputs, made with numpy from a seed, go through ``galois_tpu`` and
``galois_tpu_torch``; the tolerance is exact integer equality. Kernels
K3-K6 (the EXP/LOG table gathers) are held here through their plain
versions against the JAX Pallas kernels in interpret mode, and the table
placements of K3-K6 through the packed tables and a torch model of the
kernels' reads; the kernels themselves run only on a CUDA card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu.fields._tables import build_exp_log as jax_build_exp_log
from galois_tpu.ops._dlog import host_log as jax_host_log
from galois_tpu.ops._kernels import get_ops as jax_get_ops
from galois_tpu.ops._pallas._elementwise import (
    _pad128,
    lookup_divide_pallas,
    lookup_log_pallas,
    lookup_multiply_pallas,
    lookup_reciprocal_pallas,
)
from galois_tpu_torch.fields import _factory as torch_factory
from galois_tpu_torch.fields._tables import build_exp_log
from galois_tpu_torch.ops import _kernels
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops._lookup import (
    PLACEMENTS,
    SMEM_MAX_ORDER,
    _placed,
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
    packed_length,
)

ARITH_ORDERS = [2**8, 3**5, 5**3, 7**4, 3**10]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _restore_modes():
    """GF(q, compile=...) switches a class that each package caches: put
    every class back in the mode it had, so that no lookup-mode field leaks
    into later tests of the same worker."""
    caches = (jax_factory._FIELD_CACHE, torch_factory._FIELD_CACHE)
    saved = [{k: cls._mode for k, cls in c.items()} for c in caches]
    yield
    for cache, modes in zip(caches, saved):
        for k, cls in cache.items():
            cls._mode = modes.get(k, cls._meta.default_ufunc_mode)


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _operands(q, seed, n=200):
    """Seeded elements with zeros, ones and q - 1 at the front."""
    rng = np.random.default_rng(seed)
    head = np.array([0, 1, q - 1, 0, 2, q - 2, 1, 0], dtype=np.int64)
    a = np.concatenate([head, rng.integers(0, q, n, dtype=np.int64)])
    b = np.concatenate([head[::-1], rng.integers(0, q, n, dtype=np.int64)])
    return a, b


def _nonzero(x):
    x = x.copy()
    x[x == 0] = 1
    return x


# ----------------------------------------------------------------------
# Kernels K3-K6: plain versions against the Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q", [2**8, 3**5, 5**3, 2**10])
def test_lookup_plain_matches_pallas_interpret(q):
    Fj, Ft = gj.GF(q), gt.GF(q)
    jops, tops = jax_get_ops(Fj._meta, "jit-lookup"), get_ops(Ft._meta, "jit-lookup")
    assert np.array_equal(tops.EXP, jops.EXP) and np.array_equal(tops.LOG, jops.LOG)
    exp_p, log_p = jnp.asarray(_pad128(jops.EXP)), jnp.asarray(_pad128(jops.LOG))
    exp_t, log_t = torch.from_numpy(tops.EXP), torch.from_numpy(tops.LOG)
    rng = np.random.default_rng(q)
    a = rng.integers(0, q, 2000)
    b = rng.integers(0, q, 2000)
    a[:7], b[3:10] = 0, 0  # zeros on each side and on both
    dt_j, dt_t = Fj._meta.internal_dtype, Ft._meta.torch_dtype
    aj, bj = jnp.asarray(a.astype(dt_j)), jnp.asarray(b.astype(dt_j))
    at, bt = torch.from_numpy(a).to(dt_t), torch.from_numpy(b).to(dt_t)

    def same(got, want):
        assert np.array_equal(got.to(torch.int64).numpy(), np.asarray(want).astype(np.int64))

    same(lookup_multiply_plain(at, bt, exp_t, log_t, q), lookup_multiply_pallas(aj, bj, exp_p, log_p, q, True))
    same(lookup_divide_plain(at, bt, exp_t, log_t, q), lookup_divide_pallas(aj, bj, exp_p, log_p, q, True))
    same(lookup_reciprocal_plain(at, exp_t, log_t, q), lookup_reciprocal_pallas(aj, exp_p, log_p, q, True))
    same(lookup_log_plain(at, log_t, q), lookup_log_pallas(aj, log_p, q, True))
    assert lookup_multiply_plain(at, bt, exp_t, log_t, q).dtype == dt_t
    assert lookup_log_plain(at, log_t, q).dtype == torch.int64


def test_lookup_wrappers_use_plain_on_cpu_only():
    ops = get_ops(gt.GF(2**8)._meta, "jit-lookup")
    exp_t, log_t = (torch.from_numpy(t) for t in (ops.EXP, ops.LOG))
    a = torch.arange(256, dtype=torch.uint8)
    b = a.flip(0)
    before = [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)]
    assert torch.equal(lookup_multiply(a, b, exp_t, log_t, 256), lookup_multiply_plain(a, b, exp_t, log_t, 256))
    assert torch.equal(lookup_divide(a, b, exp_t, log_t, 256), lookup_divide_plain(a, b, exp_t, log_t, 256))
    assert torch.equal(lookup_reciprocal(a, exp_t, log_t, 256), lookup_reciprocal_plain(a, exp_t, log_t, 256))
    assert torch.equal(lookup_log(a, log_t, 256), lookup_log_plain(a, log_t, 256))
    # the plain version is no launch
    assert [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)] == before
    # not CPU and not CUDA: raise rather than fall back
    meta = a.to("meta")
    with pytest.raises(ValueError):
        lookup_multiply(meta, meta, exp_t, log_t, 256)
    with pytest.raises(ValueError):
        lookup_log(meta, log_t, 256)


# ----------------------------------------------------------------------
# K3/K4 placements: the packed tables and a model of the kernels' reads
# ----------------------------------------------------------------------

def _round8(x):
    return -(-x // 8) * 8


def _tables(q):
    ops = get_ops(gt.GF(q)._meta, "jit-lookup")
    return torch.from_numpy(ops.EXP), torch.from_numpy(ops.LOG)


@pytest.mark.parametrize(
    ["q", "dtype", "place"],
    [
        (3, torch.uint8, "bytes"),
        (3**5, torch.uint8, "bytes"),
        (2**8, torch.uint8, "bytes"),
        (3**5, torch.int64, "shared"),
        (2**10, torch.int64, "shared"),
        (SMEM_MAX_ORDER, torch.int64, "shared"),
        (SMEM_MAX_ORDER + 1, torch.int64, "log-shared"),
        (3**10, torch.int64, "log-shared"),
        (2**16, torch.int64, "log-shared"),
        (2**16 + 1, torch.int64, "global"),
        (2**20, torch.int64, "global"),
    ],
)
def test_lookup_placement_classes(q, dtype, place):
    assert lookup_placement(q, dtype) == place


@pytest.mark.parametrize(
    ["q", "dtype"], [(2**9, torch.uint8), (2**20 + 1, torch.int64), (2, torch.uint8), (2**8, torch.int32)]
)
def test_lookup_placement_refuses_what_has_no_tables(q, dtype):
    with pytest.raises(ValueError):
        lookup_placement(q, dtype)


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16])
def test_packed_tables_decode_to_the_jax_tables(q):
    """Decoded in numpy, each placement's table holds the JAX package's
    LookupOps.EXP and LOG, and INV = EXP[(q-1) - LOG]."""
    jops = jax_get_ops(gj.GF(q)._meta, "jit-lookup")
    exp_t, log_t = _tables(q)
    dtype = gt.GF(q)._meta.torch_dtype
    packed = pack_tables(exp_t, log_t, q, dtype).numpy()
    if lookup_placement(q, dtype) == "bytes":
        assert packed.dtype == np.int32 and packed.shape == (2 * (q - 1),)
        fields = packed.view(np.uint8).reshape(-1, 4).astype(np.int64)  # little-endian bytes of each row
        assert np.array_equal(fields[:q, 0], jops.LOG)
        assert np.array_equal(fields[:, 1], jops.EXP)
        assert np.array_equal(fields[:q, 2], (q - 1) - jops.LOG)
        assert np.array_equal(fields[:q, 3], jops.EXP[(q - 1) - jops.LOG])
        assert not fields[q:, [0, 2, 3]].any()
    else:
        q8, e8 = _round8(q), _round8(q - 1)
        assert packed.dtype == np.int16 and packed.shape == (2 * q8 + e8,)
        u16 = packed.view(np.uint16).astype(np.int64)
        assert np.array_equal(u16[:q], jops.LOG)
        assert np.array_equal(u16[q8 : q8 + q - 1], jops.EXP[: q - 1])
        assert np.array_equal(jops.EXP[q - 1 :], jops.EXP[: q - 1])  # the reduced EXP loses nothing
        assert np.array_equal(u16[q8 + e8 : q8 + e8 + q], jops.EXP[(q - 1) - jops.LOG])
        assert not u16[q:q8].any() and not u16[q8 + q - 1 : q8 + e8].any() and not u16[q8 + e8 + q :].any()
    big = 2**17  # 'global': the kernel reads the int32 tables themselves
    zeros = torch.zeros(2 * (big - 1), dtype=torch.int32)
    assert pack_tables(zeros, zeros[:big], big, torch.int64) is None


def _sign_fill(t):
    """prmt's sign mode, selector 0xBA98: each byte filled with its bit 7."""
    return sum(((t >> (8 * k + 7)) & 1) * (0xFF << (8 * k)) for k in range(4))


def _nonzero_bytes(w):
    """nonzero_bytes of csrc/lookup.cu on int64-held 32-bit words."""
    return _sign_fill((((w & 0x7F7F7F7F) + 0x7F7F7F7F) | w) & 0xFFFFFFFF)


def model_bytes_kernel(divide, a, b, packed):
    """bytes_kernel's reads on the CPU: the shared image of 2(q-1) rows x 32
    lanes x 4 bytes, each element read by the lane that runs it in the
    16-element vector body, a table read the byte at col + 128 r + field,
    and the zero tests as word masks."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    image = torch.stack([(words.repeat_interleave(32) >> (8 * k)) & 0xFF for k in range(4)], -1).reshape(-1)
    x, y = a.to(torch.int64), b.to(torch.int64)
    col = 4 * ((torch.arange(x.numel()) // 16) % 32)
    s = image[col + 128 * x] + image[col + 128 * y + (2 if divide else 0)]  # an index past the image raises
    r = image[col + 128 * s + 1]
    pad = -x.numel() % 4
    A, B, R = (torch.cat([v, v.new_zeros(pad)]).reshape(-1, 4) for v in (x, y, r))
    shifts = 8 * torch.arange(4)
    A, B, R = ((v << shifts).sum(-1) for v in (A, B, R))
    mask = _nonzero_bytes(A) if divide else _nonzero_bytes(A) & _nonzero_bytes(B)
    out = ((R & mask)[:, None] >> shifts) & 0xFF
    return out.reshape(-1)[: x.numel()].to(a.dtype)


def model_stream_chunk(words, v, k):
    """Stream::chunk of csrc/lookup.cu: chunk v of an operand k bytes past
    16-byte alignment, from the aligned 32-bit words around it (int64-held),
    by word selects and __funnelshift_r."""
    w = words[4 * v : 4 * v + 8]
    s, sh = k >> 2, 8 * (k & 3)
    out = []
    for j in range(4):
        x0, x1 = int(w[j + s]), int(w[j + s + 1]) if k else 0
        out.append(((x1 << 32 | x0) >> sh) & 0xFFFFFFFF)
    return out


@pytest.mark.parametrize("k", range(16))
def test_stream_chunk_model_reads_unaligned_operands(k):
    """An operand k bytes past alignment: every chunk the funnel shifts
    give is the operand's next 16 bytes."""
    buf = np.random.default_rng(k).integers(0, 256, 16 * 6, dtype=np.uint8)
    words = torch.from_numpy(buf.view(np.uint32).astype(np.int64))
    operand = buf[k:]
    for v in range(len(operand) // 16):
        got = np.array(model_stream_chunk(words, v, k), dtype=np.uint32).view(np.uint8)
        assert np.array_equal(got, operand[16 * v : 16 * v + 16])


def model_wide_kernel(divide, a, b, packed, q):
    """wide_kernel's reads on the CPU ('shared' and 'log-shared'): uint16
    LOG at [0, q), the reduced EXP at q8, one conditional add of q - 1."""
    u16 = packed.to(torch.int64) & 0xFFFF
    q8 = _round8(q)
    x, y = a.to(torch.int64), b.to(torch.int64)
    s = u16[x] - u16[y] if divide else u16[x] + u16[y] - (q - 1)
    s = s + torch.where(s < 0, q - 1, 0)
    assert int(s.min()) >= 0 and int(s.max()) < q - 1
    r = u16[q8 + s]
    zero = (x == 0) if divide else (x == 0) | (y == 0)
    return torch.where(zero, 0, r).to(a.dtype)


def _model(divide, a, b, exp_t, log_t, q):
    packed = pack_tables(exp_t, log_t, q, a.dtype)
    if lookup_placement(q, a.dtype) == "bytes":
        return model_bytes_kernel(divide, a, b, packed)
    return model_wide_kernel(divide, a, b, packed, q)


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16])
def test_kernel_read_model_matches_plain(q):
    """Every (a, b) pair of GF(2^8) and GF(3^5), 2^16 random pairs of
    GF(2^10) and GF(2^16): the model of the kernels' reads equals the plain
    versions."""
    exp_t, log_t = _tables(q)
    dtype = gt.GF(q)._meta.torch_dtype
    if q <= 2**8:
        a, b = (v.reshape(-1) for v in torch.meshgrid(torch.arange(q), torch.arange(q), indexing="ij"))
    else:
        rng = np.random.default_rng(q)
        a, b = (torch.from_numpy(rng.integers(0, q, 2**16)) for _ in range(2))
        a[:40], b[20:60] = 0, 0
        b[100:140] = q - 1
    a, b = a.to(dtype), b.to(dtype)
    assert torch.equal(_model(False, a, b, exp_t, log_t, q), lookup_multiply_plain(a, b, exp_t, log_t, q))
    assert torch.equal(_model(True, a, b, exp_t, log_t, q), lookup_divide_plain(a, b, exp_t, log_t, q))


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16])
def test_kernel_read_model_matches_jax(q):
    """A seeded sample through the model and through the JAX package: the
    Pallas kernels in interpret mode, or for GF(2^16), whose interpret-mode
    gather takes minutes to compile, the JAX field's lookup-mode operators."""
    Fj = gj.GF(q)
    jops = jax_get_ops(Fj._meta, "jit-lookup")
    exp_t, log_t = _tables(q)
    rng = np.random.default_rng(q + 7)
    a = rng.integers(0, q, 3000)
    b = rng.integers(0, q, 3000)
    a[:9], b[5:14] = 0, 0
    bn = _nonzero(b)
    dt_t = gt.GF(q)._meta.torch_dtype
    at, bt, bnt = (torch.from_numpy(v).to(dt_t) for v in (a, b, bn))
    if q <= 2**10:
        dt_j = Fj._meta.internal_dtype
        aj, bj, bnj = (jnp.asarray(v.astype(dt_j)) for v in (a, b, bn))
        exp_p, log_p = jnp.asarray(_pad128(jops.EXP)), jnp.asarray(_pad128(jops.LOG))
        want_mul = lookup_multiply_pallas(aj, bj, exp_p, log_p, q, True)
        want_div = lookup_divide_pallas(aj, bnj, exp_p, log_p, q, True)
    else:
        Fl = gj.GF(q, compile="jit-lookup")
        want_mul, want_div = Fl(a) * Fl(b), Fl(a) / Fl(bn)
    for divide, y, want in ((False, bt, want_mul), (True, bnt, want_div)):
        got = _model(divide, at, y, exp_t, log_t, q)
        assert np.array_equal(got.to(torch.int64).numpy(), np.asarray(want).astype(np.int64))


# ----------------------------------------------------------------------
# K5/K6 on the same placements: one table read per element
# ----------------------------------------------------------------------

def _decoded_inv(packed, q, place):
    """INV[0, q) as the kernels read it: byte 3 of the byte rows, or the
    third uint16 segment."""
    if place == "bytes":
        return (packed.to(torch.int64) >> 24) & 0xFF
    q8, e8 = _round8(q), _round8(q - 1)
    return packed.to(torch.int64)[q8 + e8 : q8 + e8 + q] & 0xFFFF


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16])
def test_packed_reciprocals_match_the_jax_field(q):
    """Every placement's INV holds the JAX field's reciprocals (its
    lookup-mode np.reciprocal) at r > 0, and EXP[q-1] = 1 at r = 0."""
    Fj = gj.GF(q, compile="jit-lookup")
    want = np.asarray(np.reciprocal(Fj(np.arange(1, q)))).astype(np.int64)
    exp_t, log_t = _tables(q)
    dtypes = [torch.uint8, torch.int64] if q <= 2**8 else [torch.int64]
    for dtype in dtypes:
        place = lookup_placement(q, dtype)
        inv = _decoded_inv(pack_tables(exp_t, log_t, q, dtype), q, place)[:q].numpy()
        assert inv[0] == 1 and np.array_equal(inv[1:], want), place


def model_unary_kernel(recip, a, exp_t, log_t, q):
    """The reads of bytes_unary_kernel and wide_unary_kernel on the CPU, on
    the table the wrapper would pass: K5 (recip) byte 3 or the staged INV
    segment, K6 byte 0 or the staged LOG segment, each one read per
    element; the global placement's two (K5) or one (K6) int32 gathers."""
    place = lookup_placement(q, a.dtype)
    packed = pack_tables(exp_t, log_t, q, a.dtype)
    x = a.to(torch.int64)
    if place == "bytes":
        words = packed.to(torch.int64) & 0xFFFFFFFF
        image = torch.stack([(words[:q].repeat_interleave(32) >> (8 * k)) & 0xFF for k in range(4)], -1).reshape(-1)
        col = 4 * ((torch.arange(x.numel()) // 16) % 32)  # the lane whose 16-byte chunk holds the element
        r = image[col + 128 * x + (3 if recip else 0)]  # an index past the q staged rows raises
    elif place == "global":
        r = exp_t[((q - 1) - log_t[x]).long()] if recip else log_t[x]
    else:
        q8, e8 = _round8(q), _round8(q - 1)
        start = q8 + e8 if recip else 0
        seg = packed[start : start + q8].to(torch.int64) & 0xFFFF  # the q8 staged entries
        r = seg[x]
    return r.to(a.dtype if recip else torch.int64)


UNARY_CASES = [
    (2**8, torch.uint8), (2**8, torch.int64), (3**5, torch.uint8), (3**5, torch.int64), (2**10, torch.int64),
    (2**16, torch.int64), (2**17, torch.int64),
]


@pytest.mark.parametrize(["q", "dtype"], UNARY_CASES)
def test_unary_read_model_matches_plain(q, dtype):
    """Every element of GF(2^8), GF(3^5) and GF(2^10), a seeded 2^16 sample
    of GF(2^16) and GF(2^17) (0 and q - 1 included), by every placement:
    the model of K5's and K6's reads equals the plain versions."""
    exp_t, log_t = _tables(q)
    if q <= 2**10:
        a = torch.arange(q)
    else:
        a = torch.from_numpy(np.random.default_rng(q).integers(0, q, 2**16))
        a[:30], a[30:60] = 0, q - 1
    a = a.to(dtype)
    assert torch.equal(model_unary_kernel(True, a, exp_t, log_t, q), lookup_reciprocal_plain(a, exp_t, log_t, q))
    assert torch.equal(model_unary_kernel(False, a, exp_t, log_t, q), lookup_log_plain(a, log_t, q))


@pytest.mark.parametrize("q", [2**8, 3**5, 2**10, 2**16])
def test_unary_read_model_matches_jax(q):
    """The model against the JAX package: the Pallas kernels in interpret
    mode over every element, 0 included, or for GF(2^16), whose
    interpret-mode gather is too slow here, the JAX field's lookup-mode
    np.reciprocal and log() over a seeded nonzero sample."""
    Fj = gj.GF(q)
    exp_t, log_t = _tables(q)
    if q <= 2**10:
        a = np.arange(q)
        jops = jax_get_ops(Fj._meta, "jit-lookup")
        aj = jnp.asarray(a.astype(Fj._meta.internal_dtype))
        exp_p, log_p = jnp.asarray(_pad128(jops.EXP)), jnp.asarray(_pad128(jops.LOG))
        want_inv = lookup_reciprocal_pallas(aj, exp_p, log_p, q, True)
        want_log = lookup_log_pallas(aj, log_p, q, True)
    else:
        a = np.random.default_rng(q + 3).integers(1, q, 2**12)
        Fl = gj.GF(q, compile="jit-lookup")
        want_inv, want_log = np.reciprocal(Fl(a)), Fl(a).log()
    dtypes = [torch.uint8, torch.int64] if q <= 2**8 else [torch.int64]
    for dtype in dtypes:
        at = torch.from_numpy(a).to(dtype)
        got_inv = model_unary_kernel(True, at, exp_t, log_t, q)
        got_log = model_unary_kernel(False, at, exp_t, log_t, q)
        assert np.array_equal(got_inv.to(torch.int64).numpy(), np.asarray(want_inv).astype(np.int64))
        assert np.array_equal(got_log.numpy(), np.asarray(want_log).astype(np.int64))


def test_k6_warp_transposed_stores_write_the_elements_in_order():
    """K6's uint8 body: lane l holds the 16 LOG bytes of the warp's chunk l
    as four words; store j of lane l takes halfword l % 2 of word (l % 8) / 2
    of lane 4j + l / 8 (by __shfl_sync) and writes output chunk 32j + l. The
    stores must lay the warp's 512 results out in element order."""
    logs = torch.from_numpy(np.random.default_rng(5).integers(0, 255, 512)).reshape(32, 16)  # [lane, byte]
    words = (logs.reshape(32, 4, 4) << (8 * torch.arange(4))).sum(-1)  # [lane, word], little-endian
    out = torch.full((256, 2), -1, dtype=torch.int64)
    for j in range(8):
        for lane in range(32):
            h = int(words[4 * j + (lane >> 3), (lane & 7) >> 1]) >> (16 * (lane & 1))
            out[32 * j + lane] = torch.tensor([h & 0xFF, (h >> 8) & 0xFF])
    assert torch.equal(out.reshape(-1), logs.reshape(-1))


@pytest.mark.parametrize(["q", "dtype"], [(2**8, torch.uint8), (2**10, torch.int64), (2**16, torch.int64)])
def test_packed_length_check_refuses_other_layouts(q, dtype):
    """The wrappers' check of a given table: pack_tables' own passes, one of
    the length before INV was added, or of another placement, raises."""
    exp_t, log_t = _tables(q)
    a = torch.arange(1, 10).to(dtype)
    packed = pack_tables(exp_t, log_t, q, dtype)
    place = lookup_placement(q, dtype)
    assert packed.numel() == packed_length(q, place)
    assert _placed("lookup_reciprocal", q, a, exp_t, log_t, packed) == (PLACEMENTS.index(place), packed)
    code, built = _placed("lookup_log", q, a, None, log_t, None)  # K6 packs LOG alone
    assert code == PLACEMENTS.index(place) and built.dtype == packed.dtype and built.numel() == packed.numel()
    if place == "bytes":
        assert torch.equal(built & 0xFF, packed & 0xFF)
        wrong = [packed[: q - 1], packed.to(torch.int16)]
    else:
        assert torch.equal(built[:q], packed[:q])
        wrong = [packed[: _round8(q) + _round8(q - 1)].clone(), packed.to(torch.int32)]  # the first: LOG and EXP alone
    for w in wrong:
        for fn in ("lookup_reciprocal", "lookup_log"):
            with pytest.raises(ValueError):
                _placed(fn, q, a, exp_t, log_t, w)


def test_lookup_ops_pass_packed_tables_to_k5_k6(monkeypatch):
    """LookupOps.reciprocal and log_alpha hand K5 and K6 the table cached
    for the data's device, as multiply and divide do for K3 and K4."""
    seen = []
    for name in ("lookup_reciprocal", "lookup_log"):
        real = getattr(_kernels, name)
        monkeypatch.setattr(_kernels, name, lambda *args, _f=real: seen.append(args[-1]) or _f(*args))
    F = gt.GF(2**8, compile="jit-lookup")
    ops = get_ops(F._meta, "jit-lookup")
    a = torch.arange(1, 256, dtype=torch.uint8)
    assert torch.equal(ops.reciprocal(a), lookup_reciprocal_plain(a, *_tables(256), 256))
    assert torch.equal(ops.log_alpha(a), lookup_log_plain(a, _tables(256)[1], 256))
    cached = ops._tables.packed(torch.device("cpu"))
    assert len(seen) == 2 and all(p is cached for p in seen)


def test_lookup_ops_cache_packed_tables_per_device():
    F = gt.GF(2**8, compile="jit-lookup")
    tables = get_ops(F._meta, "jit-lookup")._tables
    cpu = torch.device("cpu")
    assert tables.packed(cpu) is tables.packed(cpu)
    assert torch.equal(tables.packed(cpu), pack_tables(*tables.on(cpu), 256, torch.uint8))
    with pytest.raises(ValueError):  # EXP must repeat its first q - 1 entries
        _kernels._Tables(F._meta, np.arange(510), np.arange(256))


# ----------------------------------------------------------------------
# Tables and dispatch
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q", [2**8, 3**5, 5**3, 7**4, 2**10, 2**16])
def test_build_exp_log_matches_jax(q):
    exp, log = build_exp_log(gt.GF(q)._meta)
    exp_j, log_j = jax_build_exp_log(gj.GF(q)._meta)
    assert exp.dtype == exp_j.dtype and np.array_equal(exp, exp_j)
    assert log.dtype == log_j.dtype and np.array_equal(log, log_j)
    assert exp.shape == (2 * (q - 1),) and log.shape == (q,)


@pytest.mark.parametrize(
    ["q", "mode", "op", "kernel"],
    [
        (2**8, "jit-lookup", lambda x, y: x * y, "lookup_multiply"),
        (2**8, "jit-lookup", lambda x, y: x / y, "lookup_divide"),
        (2**8, "jit-lookup", lambda x, y: np.reciprocal(y), "lookup_reciprocal"),
        (2**8, "jit-lookup", lambda x, y: y**-1, "lookup_reciprocal"),
        (2**16, "jit-lookup", lambda x, y: x * y, "lookup_multiply"),
        (3**5, "jit-lookup", lambda x, y: x / y, "lookup_divide"),
        (3**5, "jit-calculate", lambda x, y: x * y, "lookup_multiply"),
        (3**8, "jit-calculate", lambda x, y: x * y, None),  # order > 4096: digit multiply
        (2**8, "jit-calculate", lambda x, y: x * y, None),  # K7, not a table kernel
    ],
)
def test_public_ops_route_to_the_table_kernels(monkeypatch, q, mode, op, kernel):
    """Dispatch depends on the field and mode only, so the CPU runs the
    routing the card runs: count the wrapper calls."""
    calls = []
    for name in ("lookup_multiply", "lookup_divide", "lookup_reciprocal"):
        real = getattr(_kernels, name)
        monkeypatch.setattr(_kernels, name, lambda *args, _n=name, _f=real: calls.append(_n) or _f(*args))
    F = gt.GF(q, compile=mode)
    x, y = F(np.arange(1, 41) % q), F(np.arange(1, 41) % (q - 1) + 1)
    op(x, y)
    assert calls == ([kernel] if kernel else [])


def test_lookup_mode_contract():
    for q in (2**8, 3**5, 2**20):
        assert gt.GF(q).ufunc_modes == gj.GF(q).ufunc_modes
        assert gt.GF(q).default_ufunc_mode == gj.GF(q).default_ufunc_mode == "jit-calculate"
    assert gt.GF(2).ufunc_modes == gj.GF(2).ufunc_modes
    F = gt.GF(2**8)
    F.compile("jit-lookup")
    assert F.ufunc_mode == "jit-lookup"
    F.compile("auto")
    assert F.ufunc_mode == "jit-calculate"
    with pytest.raises(ValueError):
        gt.GF(2).compile("jit-lookup")
    with pytest.raises(ValueError):
        gt.GF(2**21, compile="jit-lookup")
    try:
        F.compile("python-calculate")
        assert F.ufunc_mode == "python-calculate"
    finally:
        F.compile("auto")
    # log() in 'jit-calculate' mode reads the same LOG table (kernel K6's map)
    G = gj.GF(3**5)
    want = [jax_host_log(G._meta, v) for v in (1, 2, 3)]
    assert gt.GF(3**5)([1, 2, 3]).log().tolist() == want


# ----------------------------------------------------------------------
# Arithmetic parity in both modes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["jit-calculate", "jit-lookup"])
@pytest.mark.parametrize("q", ARITH_ORDERS)
def test_arithmetic_matches_jax(q, mode):
    Ft, Fj = gt.GF(q, compile=mode), gj.GF(q, compile=mode)
    a, b = _operands(q, seed=q)
    bn = _nonzero(b)
    xt, yt, ynt = Ft(a), Ft(b), Ft(bn)
    xj, yj, ynj = Fj(a), Fj(b), Fj(bn)
    _same(xt + yt, xj + yj)
    _same(xt - yt, xj - yj)
    _same(xt * yt, xj * yj)
    _same(-xt, -xj)
    _same(xt / ynt, xj / ynj)
    _same(np.reciprocal(ynt), np.reciprocal(ynj))
    _same(xt * 5, xj * 5)
    for e in (0, 1, 3):
        _same(xt**e, xj**e)
    # large static exponents against the JAX package's exact host field
    # (its device path compiles a ladder per exponent, seconds each)
    hf = get_host_field(Fj._meta)
    for e in (q - 1, q, 2**70 + 3):
        want = np.array([hf.power(int(v), e) for v in a]).astype(Fj._meta.internal_dtype)
        _same(xt**e, want)
    for e in (-1, -5):
        _same(ynt**e, ynj**e)
    exps = np.random.default_rng(3).integers(-40, 40, a.shape[0])
    exps[:4] = [0, 7, 0, -3]
    _same(ynt**exps, ynj**exps)
    zero_base = np.zeros(4, dtype=np.int64)
    e4 = np.array([0, 1, 2, q - 1])
    _same(Ft(zero_base) ** e4, Fj(zero_base) ** e4)


@pytest.mark.parametrize("q", ARITH_ORDERS)
def test_log_matches_jax(q):
    Ft, Fj = gt.GF(q, compile="jit-lookup"), gj.GF(q, compile="jit-lookup")
    a = _nonzero(_operands(q, seed=q + 1)[0])
    _same(Ft(a).log(), Fj(a).log())
    # a base alpha^k generates the units iff gcd(k, q - 1) = 1
    k_gen = next(k for k in range(2, q) if np.gcd(k, q - 1) == 1)
    k_not = next(k for k in range(2, q) if (q - 1) % k == 0)
    base = int(Fj.primitive_element**k_gen)
    _same(Ft(a).log(base), Fj(a).log(base))
    _same(Ft(a).log(Ft(base)), Fj(a).log(base))
    bad = int(Fj.primitive_element**k_not)
    for F in (Ft, Fj):
        with pytest.raises(ArithmeticError):
            F(a).log(bad)
        with pytest.raises(ArithmeticError):
            F([1, 0]).log()
    got = Ft(a[5]).log()
    assert isinstance(got, np.int64) and got == Fj(a[5]).log()


# ----------------------------------------------------------------------
# State carried across, and the slice as a whole
# ----------------------------------------------------------------------

def test_load_tables_from_jax_gives_the_same_results():
    q = 3**5
    Ft, Fj = gt.GF(q), gj.GF(q)
    jops = jax_get_ops(Fj._meta, "jit-lookup")
    own = _kernels.LookupOps(get_ops(Ft._meta, "jit-calculate"))
    loaded = _kernels.LookupOps(get_ops(Ft._meta, "jit-calculate"))
    loaded.load_tables(jops.EXP, jops.LOG)
    a, b = (torch.from_numpy(v).to(Ft._meta.torch_dtype) for v in _operands(q, seed=9))
    bn = torch.where(b == 0, torch.ones_like(b), b)
    for fn in ("multiply", "divide"):
        assert torch.equal(getattr(loaded, fn)(a, bn), getattr(own, fn)(a, bn))
    assert torch.equal(loaded.reciprocal(bn), own.reciprocal(bn))
    assert torch.equal(loaded.log_alpha(bn), own.log_alpha(bn))
    with pytest.raises(ValueError):
        loaded.load_tables(jops.EXP[:-1], jops.LOG)


@pytest.mark.parametrize(["q", "mode"], [(2**8, "jit-lookup"), (3**5, "jit-calculate"), (3**5, "jit-lookup")])
def test_composite_matches_jax(q, mode):
    Ft, Fj = gt.GF(q, compile=mode), gj.GF(q, compile=mode)
    rng = np.random.default_rng(q)
    x, y, z, w = (rng.integers(1, q, (6, 7)) for _ in range(4))
    got = (Ft(x) * Ft(y) + Ft(z)) / Ft(w) ** 3
    want = (Fj(x) * Fj(y) + Fj(z)) / Fj(w) ** 3
    _same(got, want)
    nz = _nonzero(np.asarray(want).astype(np.int64))
    Ft.compile("jit-lookup")
    Fj.compile("jit-lookup")
    _same(Ft(nz).log(), Fj(nz).log())
