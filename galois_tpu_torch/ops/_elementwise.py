"""Elementwise field kernels: K7 (GF(2^m) multiply, Triton), K8 (GF(2^m)
multiply for m <= 8, CUDA C++ in ``csrc/gf2m_swar.cu``), K8-A (GF(2^m)
reciprocal and powers, ``csrc/gf2m_chain.cu``), K9 and K10 (prime-field
multiplies, CUDA C++ in ``csrc/prime_mul.cu``) and K11 (the device probe,
``csrc/probe.cu``).

Each wrapper serves CPU tensors with its plain torch version, launches its
kernel for CUDA tensors and counts the launch in ``<wrapper>.launches``, and
raises on anything else. The CUDA sources' heads say what bounds K8-K11 on
the H100 and how their design differs from the TPU's. K10's plain version
uses the int64 limb helpers of ``ops/_limbs.py``, as ``LimbPrimeOps`` does.

``BinaryExtOps.multiply`` routes by field: GF(2^m) with 2 <= m <= 8 (uint8
storage) to K8, 9 <= m <= 16 to K7, larger m to a torch ladder. So the
headline GF(2^8) multiply and the Reed-Solomon decoder run K8, and BCH
decoding with GF(2^9) syndromes runs K7.

K7 replaces ``gf2m_multiply_pallas`` (``galois_tpu/ops/_pallas/_elementwise.py:493``):
an m-step shift-AND-XOR carry-less product, then reduction by f from bit
2m - 2 down to bit m.

What bounds it on the H100: the integer ALUs, not memory. A GF(2^8)
product moves 3 bytes but costs about 60 int32 shift/AND/XOR operations
(4 per ladder step, 4 per reduction step), so 2^24 products are about
1e9 operations, some 60 us at the card's int32 rate, against about 15 us
of HBM traffic (measured: 0.063 ms on an H100 80GB HBM3 at its 700 W
power limit). The design is one fused
pass: masked block loads of the storage dtype (uint8 or int64) straight
into int32 registers, the whole ladder in registers, one store. The TPU
version's cast to u32 and padding to (8, 1024) tiles are layout work for
the TPU and are not carried over; the ragged tail is masked.

K8 replaces ``gf2m_multiply_swar_pallas``
(``galois_tpu/ops/_pallas/_elementwise.py:447``): the same map for
2 <= m <= 8 on uint8 storage. The TPU kernel computes it with four
elements per 32-bit word, nibble-Karatsuba carry-less products in byte
slots and constant folds by f; its plain version below is that SWAR
algorithm in torch int64 arithmetic. On the card the kernel reads the
field's tables instead: EXP[LOG a + LOG b] from the byte rows of
``pack_tables`` in shared memory, one copy per bank, as K3 reads them.
Operands are read where they lie, by element strides along the output's
axes merged into at most three (``_merged_axes``), so the RS decoder's
broadcasts (the (B, lb, la) outer product of ``conv_trunc``, the
derivative's and Forney's rows) are not materialized.

K8-A (``gf2m_power``) computes a^(2^m - 2), the reciprocal (0 for 0), or
a**e for an int64 exponent tensor, for 2 <= m <= 16, in one launch, by the
field's tables: INV (0 masked) for the reciprocal of an operand laid out as
the output, else EXP[(LOG a * e') mod (2^m - 1)] with e' the exponent's
reduction, both operands by stride. ``BinaryExtOps.reciprocal``, ``power``
and ``power_static`` take it for those m. Its plain version is the torch
chain those methods ran before: bit-spread squares
(``gf2m_square_plain``), the Itoh-Tsujii chain (``itoh_tsujii``) and the
exponent ladder (``power_ladder``) over K7's plain product. K8, K8-A and
K8-B read one table per (m, f, device), ``_lookup.gf2m_packed_tables``: the
field's ``build_exp_log`` tables from the cache that K3-K6 read too.

Triton is imported inside the launching function, so this module imports
on machines without Triton; there the wrapper serves CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._limbs import align_planar, mul_limbs, normalize_limbs
from ._lookup import gf2m_packed_tables

__all__ = [
    "gf2m_multiply",
    "gf2m_multiply_plain",
    "gf2m_multiply_swar",
    "gf2m_multiply_swar_plain",
    "gf2m_power",
    "gf2m_power_plain",
    "gf2m_reduce_plain",
    "gf2m_square_plain",
    "itoh_tsujii",
    "power_ladder",
    "m31_multiply",
    "m31_multiply_plain",
    "goldilocks_multiply",
    "goldilocks_multiply_plain",
    "device_probe",
    "device_probe_plain",
]

M31 = 2**31 - 1
GOLDILOCKS_P = 2**64 - 2**32 + 1

_BLOCK = 1024

# Bound to ``triton.language`` by ``_triton_kernel`` on first launch; the
# kernel below reads it as a module global when Triton compiles it.
tl = None


def _gf2m_multiply_kernel(a_ptr, b_ptr, o_ptr, n, M: "tl.constexpr", F: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    a = tl.load(a_ptr + offs, mask=mask, other=0).to(tl.int32)
    b = tl.load(b_ptr + offs, mask=mask, other=0).to(tl.int32)
    acc = tl.zeros([BLOCK], dtype=tl.int32)
    for i in tl.static_range(M):
        acc = acc ^ ((a << i) & (0 - ((b >> i) & 1)))
    for k in tl.static_range(M - 1):
        i = 2 * M - 2 - k
        acc = acc ^ ((0 - ((acc >> i) & 1)) & (F << (i - M)))
    tl.store(o_ptr + offs, acc.to(o_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_gf2m_multiply_kernel)


def gf2m_multiply_plain(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """The same ladder in torch, on any device. Inputs are widened to int32
    first: ``<<`` on uint8 would drop the carry-less product's high bits."""
    a, b = torch.broadcast_tensors(a, b)
    aw = a.to(torch.int32)
    bw = b.to(torch.int32)
    acc = torch.zeros_like(aw)
    for i in range(m):
        acc = acc ^ ((aw << i) & -((bw >> i) & 1))
    for i in range(2 * m - 2, m - 1, -1):
        acc = acc ^ (-((acc >> i) & 1) & (f_int << (i - m)))
    return acc.to(a.dtype)


def gf2m_multiply(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """GF(2^m) product of two storage tensors (broadcast), m <= 16.

    CPU tensors take ``gf2m_multiply_plain``; CUDA tensors launch the
    Triton kernel (and count the launch in ``gf2m_multiply.launches``) or
    raise."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gf2m_multiply_plain(a, b, m, f_int)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gf2m_multiply: operands on {a.device} and {b.device}; need one CUDA device.")
    if a.dtype != b.dtype or a.dtype not in (torch.uint8, torch.int64):
        raise TypeError(f"gf2m_multiply: storage dtypes {a.dtype}, {b.dtype}; need uint8 or int64.")
    if not 2 <= m <= 16 or f_int >> m != 1:
        raise ValueError(f"gf2m_multiply: needs 2 <= m <= 16 and a degree-m f, got m={m}, f={f_int}.")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel()
    if n >= 2**31 - _BLOCK:
        raise ValueError(f"gf2m_multiply: {n} elements exceed the kernel's int32 offsets.")
    if n:
        kernel = _triton_kernel()
        with torch.cuda.device(a.device):
            kernel[(-(-n // _BLOCK),)](a, b, out, n, M=m, F=f_int, BLOCK=_BLOCK, num_warps=4)
        gf2m_multiply.launches += 1
    return out


gf2m_multiply.launches = 0


# ----------------------------------------------------------------------
# K8: GF(2^m) multiply, 2 <= m <= 8 (csrc/gf2m_swar.cu); its plain version
# is the TPU kernel's SWAR algorithm
# ----------------------------------------------------------------------

_ONES = 0x01010101  # bit 0 of every byte
_NIB = 0x0F0F0F0F  # low nibble of every byte
_EVEN = 0x00FF00FF  # the even bytes


def _swar_rep(v: int, slot_bits: int) -> int:
    """An integer constant replicated into every ``slot_bits`` slot of a word."""
    return sum(v << (slot_bits * k) for k in range(32 // slot_bits))


def _swar_fold(c, slot_bits: int, width: int, m: int, f: int):
    """Reduce ``width``-bit slot values mod f inside ``slot_bits`` slots."""
    r = f ^ (1 << m)
    deg_r = max(0, r.bit_length() - 1)
    low_mask = _swar_rep((1 << m) - 1, slot_bits)
    while width > m:
        h = (c >> m) & _swar_rep((1 << (width - m)) - 1, slot_bits)
        t = torch.zeros_like(c)
        for k in range(r.bit_length()):
            if (r >> k) & 1:
                t = t ^ (h << k)
        c = (c & low_mask) ^ t
        width = max(m, width - m + deg_r)
    return c


def _swar_nib_ladder(x, y, nbits: int):
    """Byte-slot carry-less product of x (at most 4-bit slots) and the
    ``nbits`` low bits of y: each slot's 0/1 bit widens to a 0x7F mask as
    (bit << 7) - bit, and no borrow crosses a slot."""
    acc = torch.zeros_like(x)
    for i in range(nbits):
        bit = (y >> i) & _ONES
        acc = acc ^ ((x << i) & ((bit << 7) - bit))
    return acc


def _swar_mul_core(A, B, m: int, f: int):
    """GF(2^m) products, m <= 8, of int64 tensors holding u32 words of four
    packed uint8 elements: nibble Karatsuba keeps every partial product
    under 8 bits, then the 15-bit products are re-slotted into the 16-bit
    slots of the even and the odd bytes for the folds by f. The values stay
    non-negative and below 2^36, so int64 ``>>`` is the logical shift."""
    if m <= 4:
        return _swar_fold(_swar_nib_ladder(A, B, m), 8, 2 * m - 1, m, f)
    al, ah = A & _NIB, (A >> 4) & _NIB
    bl, bh = B & _NIB, (B >> 4) & _NIB
    ll = _swar_nib_ladder(al, bl, 4)
    hh = _swar_nib_ladder(ah, bh, m - 4)
    mid = _swar_nib_ladder(al ^ ah, bl ^ bh, 4) ^ ll ^ hh
    pe = ((hh & _EVEN) << 8) ^ ((mid & _EVEN) << 4) ^ (ll & _EVEN)
    po = (((hh >> 8) & _EVEN) << 8) ^ (((mid >> 8) & _EVEN) << 4) ^ ((ll >> 8) & _EVEN)
    pe = _swar_fold(pe, 16, 2 * m - 1, m, f)
    po = _swar_fold(po, 16, 2 * m - 1, m, f)
    return pe | (po << 8)


def _check_swar(a, b, m: int, f_int: int) -> None:
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"gf2m_multiply_swar: storage dtypes {a.dtype}, {b.dtype}; need uint8.")
    if not 2 <= m <= 8 or f_int >> m != 1:
        raise ValueError(f"gf2m_multiply_swar: needs 2 <= m <= 8 and a degree-m f, got m={m}, f={f_int}.")


def gf2m_multiply_swar_plain(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K8's algorithm in torch, on any device: pad to a multiple of 4
    elements, reinterpret the bytes as int32 words, widen them to int64
    (torch has no uint32 arithmetic, and int32's ``>>`` is arithmetic), run
    the SWAR core and reinterpret the words as bytes again."""
    a, b = torch.broadcast_tensors(a, b)
    _check_swar(a, b, m, f_int)
    shape, n = a.shape, a.numel()

    def words(x):
        buf = torch.zeros(n + (-n) % 4, dtype=torch.uint8, device=x.device)
        buf[:n] = x.reshape(-1)
        return buf.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    w = _swar_mul_core(words(a), words(b), m, f_int)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    return w.view(torch.uint8)[:n].reshape(shape)


@functools.lru_cache(maxsize=None)
def _swar_lib():
    from .._build import load

    lib = load("gf2m_swar")
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.gf2m_swar_launch.argtypes = [vp, i64, i64, i64, vp, i64, i64, i64, vp, i64, i64, i64, ctypes.c_int, vp, vp]
    lib.gf2m_swar_launch.restype = ctypes.c_int
    return lib


def gf2m_multiply_swar(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K8: GF(2^m) product of two uint8 storage tensors (broadcast), 2 <= m <= 8.

    CPU tensors take ``gf2m_multiply_swar_plain``; CUDA tensors launch the
    kernel (counted in ``gf2m_multiply_swar.launches``) or raise. The kernel
    reads the field's byte rows (``gf2m_packed_tables``) and takes broadcast
    operands in place by stride where the output's axes merge into three;
    beyond that they are materialized first."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gf2m_multiply_swar_plain(a, b, m, f_int)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gf2m_multiply_swar: operands on {a.device} and {b.device}; need one CUDA device.")
    _check_swar(a, b, m, f_int)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.uint8, device=a.device)
    n = out.numel()
    if n:
        (a, b), n1, n2, (sa, sb) = _strided(shape, (a, b))
        rows = gf2m_packed_tables(m, f_int, a.device)
        with torch.cuda.device(a.device):
            rc = _swar_lib().gf2m_swar_launch(
                a.data_ptr(), *sa, b.data_ptr(), *sb, out.data_ptr(), n, n1, n2, m, rows.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"gf2m_multiply_swar: kernel launch failed with CUDA error {rc}.")
        gf2m_multiply_swar.launches += 1
    return out


gf2m_multiply_swar.launches = 0


# ----------------------------------------------------------------------
# K8-A: GF(2^m) reciprocal and powers, 2 <= m <= 16, by the field's tables
# (csrc/gf2m_chain.cu); its plain version is the torch chain
# ----------------------------------------------------------------------

def gf2m_reduce_plain(c: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """Carry-less products (int64, at most 2m - 1 bits) mod f by constant
    folds: x^m = r (mod f) with r = f ^ x^m. Returns int64."""
    r = f_int ^ (1 << m)
    r_bits = [k for k in range(r.bit_length()) if (r >> k) & 1]
    deg_r = max(r_bits, default=0)
    width = 2 * m - 1
    while width > m:
        o = c >> m
        c = c & ((1 << m) - 1)
        for k in r_bits:
            c = c ^ (o << k)
        width = max(m, width - m + deg_r)
    return c


def gf2m_square_plain(a: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """GF(2^m) square of a storage tensor, any m <= 32: bit i spreads to bit
    2i (one torch pass per bit), then the folds by f."""
    aw = a.to(torch.int64)
    acc = torch.zeros_like(aw)
    for i in range(m):
        acc = acc ^ (((aw >> i) & 1) << (2 * i))
    return gf2m_reduce_plain(acc, m, f_int).to(a.dtype)


def itoh_tsujii(a, m: int, square, multiply):
    """a^(2^m - 2), the inverse of a (0 for 0), by the Itoh-Tsujii chain:
    t = a^(2^k - 1) along the bits of m - 1 below the top one (k -> 2k:
    t^(2^k) t; k -> k + 1: t^2 a), then t^2."""
    t = a
    k = 1
    for bit in bin(m - 1)[3:]:
        tk = t
        for _ in range(k):
            tk = square(tk)
        t = multiply(tk, t)
        k *= 2
        if bit == "1":
            t = multiply(square(t), a)
            k += 1
    return square(t)


def power_ladder(a, e, nbits: int, one_like, square, multiply):
    """a**e for a non-negative int64 exponent tensor below 2^nbits (broadcast
    against a): a binary ladder over the exponent's bits, 0**0 = 1."""
    a, e = torch.broadcast_tensors(a, e)
    result = one_like(a)
    base = a
    for i in range(nbits):
        bit = ((e >> i) & 1).bool()
        result = torch.where(bit, multiply(result, base), result)
        if i + 1 < nbits:
            base = square(base)
    return result


def gf2m_power_plain(a: torch.Tensor, e, m: int, f_int: int, nbits: int = 0) -> torch.Tensor:
    """K8-A's map in torch, on any device: the reciprocal by the Itoh-Tsujii
    chain when ``e`` is None, else the ladder over the low ``nbits`` bits of
    the int64 exponent tensor ``e``; products are K7's plain ladder."""

    def square(x):
        return gf2m_square_plain(x, m, f_int)

    def multiply(x, y):
        return gf2m_multiply_plain(x, y, m, f_int)

    if e is None:
        return itoh_tsujii(a, m, square, multiply)
    return power_ladder(a, e, nbits, torch.ones_like, square, multiply)


@functools.lru_cache(maxsize=None)
def _chain_lib():
    """``csrc/gf2m_chain.cu``: K8-A (``gf2m_power_launch``) and K8-B
    (``bm_scan_launch``, wrapped in ``ops/_bm_scan.py``)."""
    from .._build import load

    lib = load("gf2m_chain")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gf2m_power_launch.argtypes = [vp, i64, i64, i64, vp, i64, i64, i64, i32, vp, i64, i64, i64, i32, vp, vp]
    lib.bm_scan_launch.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, ctypes.c_uint, vp]
    lib.gf2m_power_launch.restype = lib.bm_scan_launch.restype = i32
    return lib


def _merged_axes(shape, *strides):
    """The elements of ``shape``, in order, as three axes (n0, n1, n2) with
    per-operand element strides [(s0, s1, s2), ...]: axes of size 1
    dropped, neighbours merged where every operand's strides allow, missing
    outer axes of size 1 and stride 0. None when more than three axes
    remain."""
    merged = []
    for i, size in enumerate(shape):
        if size == 1:
            continue
        st = [s[i] for s in strides]
        if merged and all(p == q * size for p, q in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * size, st)
        else:
            merged.append((size, st))
    if len(merged) > 3:
        return None
    merged = [(1, [0] * len(strides))] * (3 - len(merged)) + merged
    return tuple(size for size, _ in merged), [tuple(st[k] for _, st in merged) for k in range(len(strides))]


def _strided(shape, operands):
    """The operands as a kernel of K8 or K8-A reads them: views broadcast to
    ``shape``, with the inner axes (n1, n2) of ``_merged_axes`` and each
    operand's strides along the three. A layout of more than three axes is
    materialized first."""
    views = [x.expand(shape) for x in operands]
    layout = _merged_axes(shape, *(v.stride() for v in views))
    if layout is None:
        views = [v.contiguous() for v in views]
        layout = _merged_axes(shape, *(v.stride() for v in views))
    (_, n1, n2), strides = layout
    return views, n1, n2, strides


def gf2m_power(a: torch.Tensor, e, m: int, f_int: int, nbits: int = 0) -> torch.Tensor:
    """K8-A: a^(2^m - 2), the reciprocal (0 for 0), when ``e`` is None; else
    a**e for the int64 exponent tensor ``e`` (broadcast against a; its low
    ``nbits`` bits count, 0**0 = 1). GF(2^m), 2 <= m <= 16, storage uint8
    for m <= 8 and int64 above.

    CPU tensors take ``gf2m_power_plain``; CUDA tensors launch the kernel
    (counted in ``gf2m_power.launches``) or raise. The kernel reads the
    field's tables (``gf2m_packed_tables``); broadcast operands are read by
    stride where the output's axes merge into three, beyond that they are
    materialized first."""
    if a.device.type == "cpu" and (e is None or e.device.type == "cpu"):
        return gf2m_power_plain(a, e, m, f_int, nbits)
    if a.device.type != "cuda" or (e is not None and e.device != a.device):
        raise ValueError(f"gf2m_power: operands on {a.device} and {None if e is None else e.device}; need one CUDA device.")
    if not 2 <= m <= 16 or f_int >> m != 1 or not 0 <= nbits <= 64:
        raise ValueError(f"gf2m_power: needs 2 <= m <= 16, a degree-m f and 0 <= nbits <= 64, got m={m}, f={f_int}, nbits={nbits}.")
    dtype = torch.uint8 if m <= 8 else torch.int64
    if a.dtype != dtype or (e is not None and e.dtype != torch.int64):
        raise TypeError(f"gf2m_power: a of {a.dtype} and e of {None if e is None else e.dtype}; need {dtype} and int64.")
    shape = a.shape if e is None else torch.broadcast_shapes(a.shape, e.shape)
    out = torch.empty(shape, dtype=dtype, device=a.device)
    n = out.numel()
    if n:
        ops, n1, n2, st = _strided(shape, [a] if e is None else [a, e])
        e_ptr, e_st = (None, (0, 0, 0)) if e is None else (ops[1].data_ptr(), st[1])
        tab = gf2m_packed_tables(m, f_int, a.device)
        with torch.cuda.device(a.device):
            rc = _chain_lib().gf2m_power_launch(
                ops[0].data_ptr(), *st[0], e_ptr, *e_st, nbits, out.data_ptr(), n, n1, n2, m, tab.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"gf2m_power: kernel launch failed with CUDA error {rc}.")
        gf2m_power.launches += 1
    return out


gf2m_power.launches = 0


# ----------------------------------------------------------------------
# K9 and K10: prime-field multiplies (csrc/prime_mul.cu)
# ----------------------------------------------------------------------

# Below this period the broadcast operand is materialized instead: the
# kernel's grid covers one period per block row.
_MIN_PERIOD = 4096


def m31_multiply_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^31 - 1 for int64 storage (broadcast): the int64 product
    (< 2^62) and ``%``."""
    return a.to(torch.int64) * b.to(torch.int64) % M31


def goldilocks_multiply_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Goldilocks product of planar (4, ...) uint16 limb tensors, as
    ``GoldilocksOps.multiply_t`` of the JAX package: the 4 x 4 schoolbook
    product of 16-bit limbs carry-normalized to 8 digits g, then the folds
    2^64 = 2^32 - 1 and 2^96 = -1 (mod p) in signed 16-bit columns and one
    conditional subtract of p. Any 64-bit operands, also those in
    [p, 2^64), give the canonical residue."""
    a, b = align_planar(a, b)
    g = mul_limbs(a.to(torch.int64), b.to(torch.int64))  # < 2^128: 8 digits
    cols = torch.stack([g[0] - g[4] - g[6], g[1] - g[5] - g[7], g[2] + g[4], g[3] + g[5]])
    nd = cols.ndim - 1
    fold = torch.tensor([-1, 0, 1, 0], device=cols.device).reshape((4,) + (1,) * nd)
    for _ in range(2):
        cols, carry = normalize_limbs(cols)
        cols = cols + carry * fold  # carry * 2^64 = carry * (2^32 - 1)
    cols, _ = normalize_limbs(cols)  # the end carry is 0 here
    p_limbs = torch.tensor([1, 0, 0xFFFF, 0xFFFF], device=cols.device).reshape((4,) + (1,) * nd)
    diff, borrow = normalize_limbs(cols - p_limbs)
    return torch.where(borrow == 0, diff, cols).to(torch.uint16)


@functools.lru_cache(maxsize=None)
def _prime_lib():
    from .._build import load

    lib = load("prime_mul")
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.m31_multiply_launch, lib.goldilocks_multiply_launch):
        fn.argtypes = [vp, vp, vp, i64, i64, vp]
        fn.restype = ctypes.c_int
    return lib


def _is_period(es, shape) -> bool:
    """True when an operand of element shape ``es`` broadcast to ``shape``
    repeats its own elements in order: ones, then the trailing axes of
    ``shape``."""
    es = (1,) * (len(shape) - len(es)) + tuple(es)
    j = next((i for i, s in enumerate(es) if s != 1), len(es))
    return es[j:] == tuple(shape[j:])


def _periodic(a, b, lead: int):
    """Operands for a launch: (a, b, shape, n, nb) with a contiguous over
    ``lead`` leading storage axes and the element ``shape``, and b
    contiguous with nb elements per plane that repeat every nb elements of
    a. The product is commutative, so b is whichever operand repeats;
    neither does, or too short a period, materializes the broadcast."""
    ea, eb = tuple(a.shape[lead:]), tuple(b.shape[lead:])
    shape = tuple(torch.broadcast_shapes(ea, eb))
    n = math.prod(shape)
    if ea != shape and eb == shape:
        a, b, ea, eb = b, a, eb, ea
    nb = math.prod(eb)
    if ea != shape or not _is_period(eb, shape) or (nb < _MIN_PERIOD and nb != n):
        full = tuple(a.shape[:lead]) + shape
        a, b, nb = a.expand(full), b.expand(full), n
    return a.contiguous(), b.contiguous(), shape, n, nb


def _launch_prime(fn: str, a, b, out, n: int, nb: int) -> None:
    with torch.cuda.device(a.device):
        rc = getattr(_prime_lib(), f"{fn}_launch")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, nb,
            ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}.")


def _check_cuda(fn: str, a, b, dtype) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{fn}: operands on {a.device} and {b.device}; need one CUDA device.")
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"{fn}: storage dtypes {a.dtype}, {b.dtype}; need {dtype}.")


def m31_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K9: GF(2^31 - 1) product of two int64 storage tensors (broadcast).

    CPU tensors take ``m31_multiply_plain``; CUDA tensors launch the kernel
    (counted in ``m31_multiply.launches``) or raise."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return m31_multiply_plain(a, b)
    _check_cuda("m31_multiply", a, b, torch.int64)
    a, b, shape, n, nb = _periodic(a, b, lead=0)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if n:
        _launch_prime("m31_multiply", a, b, out, n, nb)
        m31_multiply.launches += 1
    return out


def goldilocks_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10: Goldilocks product of planar (4, ...) uint16 limb tensors; the
    element axes broadcast right-aligned behind the limb axis.

    CPU tensors take ``goldilocks_multiply_plain``; CUDA tensors launch the
    kernel (counted in ``goldilocks_multiply.launches``) or raise. A
    broadcast operand that repeats, such as x of shape (4, 1, N) against
    (4, k, N) in Horner's inner step, is passed with its period, not
    materialized."""
    a, b = align_planar(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return goldilocks_multiply_plain(a, b)
    _check_cuda("goldilocks_multiply", a, b, torch.uint16)
    if a.shape[0] != 4 or b.shape[0] != 4:
        raise ValueError(f"goldilocks_multiply: needs 4 limb planes, got {a.shape[0]} and {b.shape[0]}.")
    a, b, shape, n, nb = _periodic(a, b, lead=1)
    out = torch.empty((4,) + shape, dtype=torch.uint16, device=a.device)
    if n:
        _launch_prime("goldilocks_multiply", a, b, out, n, nb)
        goldilocks_multiply.launches += 1
    return out


m31_multiply.launches = 0
goldilocks_multiply.launches = 0


# ----------------------------------------------------------------------
# K11: the device probe (csrc/probe.cu)
# ----------------------------------------------------------------------

def device_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """x + 1."""
    return x + 1


@functools.lru_cache(maxsize=None)
def _probe_lib():
    from .._build import load

    lib = load("probe")
    lib.probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.probe_launch.restype = ctypes.c_int
    return lib


def device_probe(x: torch.Tensor) -> torch.Tensor:
    """K11: x + 1 for an int32 tensor, such as the (8, 1024) block of the
    TPU probe. CPU tensors take the plain version; a CUDA tensor launches
    the kernel (counted in ``device_probe.launches``) or raises."""
    if x.device.type == "cpu":
        return device_probe_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.int32:
        raise ValueError(f"device_probe: needs an int32 CUDA tensor, got {x.dtype} on {x.device}.")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _probe_lib().probe_launch(
                x.data_ptr(), out.data_ptr(), x.numel(),
                ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"device_probe: kernel launch failed with CUDA error {rc}.")
        device_probe.launches += 1
    return out


device_probe.launches = 0
