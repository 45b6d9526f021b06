"""Kernel K14: GF(2^m) products, squares and powers for m > 32 on planar
uint16 limbs (CUDA C++ in ``csrc/gf2_limb.cu``; its head gives the design
and what bounds it on the H100).

The storage of GF(2^m), m > 32, is L = ceil(m / 16) little-endian uint16
limbs of the m coefficient bits, planar: shape (L, *shape), the limb axis
leading (``fields/_meta.py``). K14 replaces the ``lax.scan`` products of the
JAX package's ``LimbBinaryOps`` (``multiply_t``, ``square_t`` and
``_reduce_t``, ``galois_tpu/ops/_kernels.py:1345-1416``): one thread an
element, its limbs in 32-bit words in registers; the product is a comb with a
4-bit window over a table of the 16 multiples of a in shared memory, the
square spreads bits, and one reduction serves both: by the few terms of a
sparse f, or a byte at a time through a table of b x^m mod f
(``fold_inputs`` builds both from f on the host). The power entry runs a
whole chain in registers, one launch a call: Itoh-Tsujii for the
reciprocal, squares for a^(2^j), a square-and-multiply ladder otherwise.

The plain versions are the same maps in torch, on any device. A product
of many elements is a bit-serial form on (W, n) int64 words (W = ceil(m /
64)), a torch pass a step (about 8m launches a product), in chunks of
``_PLAIN_CHUNK_BYTES``; a product of few elements (n 2m^2 bytes at most
``_OUTER_BYTES``) is a skewed outer product of the elements' bits summed
mod 2, then the reduction as one GF(2) matrix product, a few launches
whatever m. A square is one GF(2) matrix product of the bits with the
squaring matrix (squaring is linear in characteristic 2).

Each wrapper serves CPU tensors with its plain version, launches its kernel
for CUDA tensors and counts the launch in ``<wrapper>.launches``, and raises
on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._elementwise import itoh_tsujii
from ._limbs import _i16, align_planar, planar_power_words

__all__ = [
    "fold_inputs",
    "gf2_limb_multiply",
    "gf2_limb_multiply_plain",
    "gf2_limb_square",
    "gf2_limb_square_plain",
    "gf2_limb_power",
    "gf2_limb_power_plain",
    "MAX_WORDS",
]

MAX_WORDS = 9  # W <= 9 64-bit words: m <= 576, NIST's largest binary field GF(2^571) included
_EXP_WORDS = 10  # a public exponent below 2^640 (the kernel's argument struct)
_PLAIN_CHUNK_BYTES = 1 << 27
_OUTER_BYTES = 1 << 24  # the plain product's outer-product form up to this many bytes
_SPARSE_TERMS = 5  # a sparse f - x^m: at most this many terms, of degree at most m / 2
# Moduli at K14's edges, for its checks against the plain versions: the word edges m = 33 (the
# least), 65 (one bit into a second 64-bit word) and 576 (the most), sparse f; and dense irreducible
# f of degree 64, 128 and 129 (more than half their coefficients nonzero, from
# irreducible_poly(2, m, method="random")), which only the byte table reduces
EDGE_MODULI = [(33, 2**33 + 2**13 + 1), (65, 2**65 + 2**18 + 1), (576, 2**576 + 2**11 + 2**5 + 2**2 + 1)]
DENSE_MODULI = [
    (64, 0x1FFB8B0884E9E4FE5), (128, 0x1BAFF70836FDA3851C04476E3579F8B0B), (129, 0x3A92BF38946685B87E8BA19981BDB8B1B),
]


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fold_rows(m: int, f_int: int) -> np.ndarray:
    """(m - 1, m) 0/1 rows: row k holds the bits of x^(m + k) mod f."""
    rows, cur = [], f_int ^ (1 << m)  # x^m mod f
    for _ in range(m - 1):
        rows.append([(cur >> j) & 1 for j in range(m)])
        cur <<= 1
        if cur >> m:
            cur ^= f_int
    return np.asarray(rows, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _square_matrix(m: int, f_int: int) -> np.ndarray:
    """(m, m) 0/1 matrix S over GF(2): bits(a^2) = bits(a) @ S."""
    R = _fold_rows(m, f_int)
    S = np.zeros((m, m), dtype=np.float32)
    for i in range(m):
        if 2 * i < m:
            S[i, 2 * i] = 1
        else:
            S[i] = R[2 * i - m]
    return S


def _const_on(arr: np.ndarray, device) -> torch.Tensor:
    return _const_cached(arr.tobytes(), arr.shape, str(device))


@functools.lru_cache(maxsize=64)
def _const_cached(raw: bytes, shape, device: str) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.float32).reshape(shape).to(device)


def _to_bits(x: torch.Tensor, m: int) -> torch.Tensor:
    """Planar limbs (L, n) -> bits (n, m), float32 0/1."""
    w = x.view(torch.int16).to(torch.int32) & 0xFFFF
    k = torch.arange(m, device=x.device)
    return ((w[k // 16] >> (k % 16).unsqueeze(-1)) & 1).T.to(torch.float32)


def _from_bits(bits: torch.Tensor, L: int) -> torch.Tensor:
    """Bits (n, m), int64 0/1 -> planar uint16 limbs (L, n)."""
    n, m = bits.shape
    padded = torch.zeros((n, 16 * L), dtype=torch.int64, device=bits.device)
    padded[:, :m] = bits
    weights = 1 << torch.arange(16, device=bits.device)
    limbs = (padded.reshape(n, L, 16) * weights).sum(-1)
    return limbs.T.to(torch.int32).to(torch.int16).view(torch.uint16).contiguous()


def _planar_pair(a: torch.Tensor, b: torch.Tensor):
    """Two planar operands broadcast to one element shape, flattened to (L, n)."""
    a, b = align_planar(a, b)
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    L = a.shape[0]
    a = _i16(a).expand((L,) + tuple(shape)).reshape(L, -1).view(torch.uint16)
    b = _i16(b).expand((L,) + tuple(shape)).reshape(L, -1).view(torch.uint16)
    return a, b, tuple(shape)


def _clmul_reduce_bits(A: torch.Tensor, B: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """Bits (n, m) x bits (n, m) -> bits (n, m) of the product mod f (int64):
    the skewed outer product summed mod 2, then one GF(2) matrix product of
    the high half by the rows x^(m + k) mod f."""
    n = A.shape[0]
    z = torch.zeros((n, m, 2 * m), dtype=torch.uint8, device=A.device)
    z[:, :, :m] = A.to(torch.uint8).unsqueeze(-1) & B.to(torch.uint8).unsqueeze(-2)
    # the skew: row i moves i places right, so the column sums are the product's coefficients
    c = z.reshape(n, 2 * m * m)[:, : m * (2 * m - 1)].reshape(n, m, 2 * m - 1).sum(1) & 1
    hi = (c[:, m:].to(torch.float32) @ _const_on(_fold_rows(m, f_int), A.device)).to(torch.int64)
    return (c[:, :m] ^ hi) & 1


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _to_words(x: torch.Tensor, W: int) -> torch.Tensor:
    """Planar limbs (L, n) -> (W, n) int64 words, four limbs a word."""
    limbs = x.view(torch.int16).to(torch.int64) & 0xFFFF
    words = torch.zeros((W,) + tuple(x.shape[1:]), dtype=torch.int64, device=x.device)
    for k in range(x.shape[0]):
        words[k // 4] |= limbs[k] << (16 * (k % 4))
    return words


def _from_words(words: torch.Tensor, L: int) -> torch.Tensor:
    """(W, n) int64 words -> planar uint16 limbs (L, n)."""
    limbs = [(words[k // 4] >> (16 * (k % 4))) & 0xFFFF for k in range(L)]
    return torch.stack(limbs).to(torch.int32).to(torch.int16).view(torch.uint16)


def _mulmod_words(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """The bit-serial product on (W, n) int64 words: b's bits from the top,
    r = r x mod f, then r ^= a where the bit is set (the x^m overflow of
    r x folds in as r = f - x^m)."""
    W = a.shape[0]
    top = m - 64 * (W - 1)  # bits in the top word, 1..64
    fr = torch.tensor([_signed(((f_int ^ (1 << m)) >> (64 * k)) & (2**64 - 1)) for k in range(W)], device=a.device)
    fr = fr.reshape((W,) + (1,) * (a.ndim - 1))
    top_mask = _signed((1 << top) - 1) if top < 64 else -1
    r = torch.zeros_like(a)
    for w in reversed(range(W)):
        for t in reversed(range(top if w == W - 1 else 64)):
            carry = (r[W - 1] >> (top - 1)) & 1
            low = (r[:-1] >> 63) & 1
            r = r << 1
            r[1:] |= low
            r[W - 1] &= top_mask
            r = r ^ (fr & -carry)
            r = r ^ (a & -((b[w] >> t) & 1))
    return r


def gf2_limb_multiply_plain(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K14's product in torch: planar limbs a (L, *sa) and b (L, *sb) of
    GF(2^m) with modulus f, element axes broadcast -> (L, *shape)."""
    L = a.shape[0]
    a2, b2, shape = _planar_pair(a, b)
    n = a2.shape[1]
    out = torch.empty((L, n), dtype=torch.uint16, device=a.device)
    if n * 2 * m * m <= _OUTER_BYTES:  # few elements: the outer product, a few launches
        out = _from_bits(_clmul_reduce_bits(_to_bits(a2, m), _to_bits(b2, m), m, f_int), L)
        return out.reshape((L,) + shape)
    W = -(-m // 64)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (64 * W))
    for s in range(0, n, chunk):
        A, B = _to_words(a2[:, s : s + chunk], W), _to_words(b2[:, s : s + chunk], W)
        out[:, s : s + chunk] = _from_words(_mulmod_words(A, B, m, f_int), L)
    return out.reshape((L,) + shape)


def gf2_limb_square_plain(a: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K14's square in torch: bits(a) @ S mod 2, one GF(2) matrix product."""
    L = a.shape[0]
    shape = tuple(a.shape[1:])
    flat = a.reshape(L, -1)
    S = _const_on(_square_matrix(m, f_int), a.device)
    out = torch.empty_like(flat)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (4 * m))
    for s in range(0, flat.shape[1], chunk):
        bits = (_to_bits(flat[:, s : s + chunk], m) @ S).to(torch.int64) & 1
        out[:, s : s + chunk] = _from_bits(bits, L)
    return out.reshape((L,) + shape)


def _one_like(a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros(a.shape, dtype=torch.int16, device=a.device)
    one[0].fill_(1)
    return one.view(torch.uint16)


def gf2_limb_power_plain(a: torch.Tensor, e, m: int, f_int: int, nbits: int = 0) -> torch.Tensor:
    """K14's power in torch. ``e`` a Python int >= 0: a^e (a^0 = 1), the
    reciprocal 2^m - 2 by the Itoh-Tsujii chain. ``e`` a list of int64 word
    tensors (62 bits a word, broadcast against a's elements): a**e over the
    low ``nbits`` bits, 0**0 = 1."""

    def square(x):
        return gf2_limb_square_plain(x, m, f_int)

    def multiply(x, y):
        return gf2_limb_multiply_plain(x, y, m, f_int)

    if isinstance(e, int):
        if e == 2**m - 2:
            return itoh_tsujii(a, m, square, multiply)
        result = _one_like(a)
        for bit in bin(e)[2:] if e else "":
            result = multiply(square(result), a) if bit == "1" else square(result)
        return result
    return planar_power_words(a, e, nbits, multiply, square, _one_like)


# ----------------------------------------------------------------------
# The reduction's host inputs
# ----------------------------------------------------------------------

def _mod(v: int, m: int, f_int: int) -> int:
    """v mod f in Python ints (f of degree m)."""
    for i in range(v.bit_length() - 1, m - 1, -1):
        if (v >> i) & 1:
            v ^= f_int << (i - m)
    return v


@functools.lru_cache(maxsize=None)
def fold_inputs(m: int, f_int: int):
    """The kernel's reduction inputs for f of degree m, in its frame shifted
    by s = 32 N - m (N = 2 ceil(m / 64) 32-bit words, so that x^m sits at
    bit 32 N): (s, terms, table). ``terms`` is the list of (q, r) with
    s + e = 32 q + r for each exponent e of f - x^m when it has at most 5
    terms of degree at most m / 2 (two folds of the high half by those
    terms reduce any product), else None; ``table`` is the (256, N) uint32
    array of (b x^m mod f) x^s, b < 256, for the top-down byte fold that
    serves every f (the kernel reads it only when ``terms`` is None)."""
    N = 2 * -(-m // 64)
    s = 32 * N - m
    low = f_int ^ (1 << m)
    exps = [i for i in range(low.bit_length()) if (low >> i) & 1]
    terms = None
    if len(exps) <= _SPARSE_TERMS and 2 * max(exps, default=0) <= m:
        terms = [divmod(s + e, 32) for e in exps]
    rows = [_mod(b << m, m, f_int) << s for b in range(256)]
    table = np.array([[(v >> (32 * w)) & 0xFFFFFFFF for w in range(N)] for v in rows], dtype=np.uint32)
    return s, terms, table


@functools.lru_cache(maxsize=64)
def _device_table(m: int, f_int: int, device: str) -> torch.Tensor:
    """``fold_inputs``' byte table on ``device``, once per (m, f, device)."""
    table = fold_inputs(m, f_int)[2]
    return torch.from_numpy(table.view(np.int32).copy()).to(device)


# ----------------------------------------------------------------------
# The kernel's wrappers
# ----------------------------------------------------------------------

class _Words(ctypes.Structure):
    _fields_ = [("w", ctypes.c_ulonglong * _EXP_WORDS)]


class _Fold(ctypes.Structure):
    _fields_ = [("sparse", ctypes.c_int), ("nterms", ctypes.c_int), ("q", ctypes.c_int * _SPARSE_TERMS),
                ("r", ctypes.c_int * _SPARSE_TERMS)]


def _fold(m: int, f_int: int, device):
    """(the kernel's fold struct, the byte table's pointer or None) for f."""
    terms = fold_inputs(m, f_int)[1]
    if terms is None:
        return _Fold(0, 0), _device_table(m, f_int, str(device))
    fold = _Fold(1, len(terms))
    for i, (q, r) in enumerate(terms):
        fold.q[i], fold.r[i] = q, r
    return fold, None


def _words(x: int, count: int = _EXP_WORDS) -> _Words:
    out = _Words()
    for k in range(count):
        out.w[k] = (x >> (64 * k)) & (2**64 - 1)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("gf2_limb")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gf2_limb_mul_launch.argtypes = [vp, i64, i64, vp, i64, i64, vp, i64, i32, _Fold, vp, i32, vp]
    lib.gf2_limb_pow_launch.argtypes = [vp, i64, i64, vp, i64, i32, _Fold, vp, i32, _Words, i32, vp, i64, i64, vp]
    lib.gf2_limb_mul_launch.restype = lib.gf2_limb_pow_launch.restype = i32
    return lib


def _check(name: str, m: int, f_int: int, *xs) -> None:
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}; need one CUDA device.")
    L = -(-m // 16)
    if not 32 < m <= 64 * MAX_WORDS or f_int >> m != 1:
        raise ValueError(f"{name}: needs 32 < m <= {64 * MAX_WORDS} and a degree-m f, got m={m}, f={f_int}.")
    if xs[0].dtype != torch.uint16 or xs[0].shape[0] != L:
        raise TypeError(f"{name}: needs planar uint16 limbs ({L}, ...), got {xs[0].dtype} {tuple(xs[0].shape)}.")


def _operand(x: torch.Tensor, L: int, shape):
    """A planar operand as the kernel reads it: (tensor, plane stride,
    element stride); one element by stride 0, else (L, n) contiguous."""
    x = _i16(x)
    if x[0].numel() == 1:
        flat = x.reshape(L, 1)
        return flat, flat.stride(0), 0
    flat = x.expand((L,) + tuple(shape)).reshape(L, -1).contiguous()
    return flat, flat.shape[1], 1


def gf2_limb_multiply(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K14: the GF(2^m) product of planar limbs a (L, *sa) and b (L, *sb),
    element axes broadcast. CPU tensors take ``gf2_limb_multiply_plain``;
    CUDA tensors launch the kernel (counted in
    ``gf2_limb_multiply.launches``) or raise. A one-element operand is
    read by stride 0; other broadcasts are materialized first."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gf2_limb_multiply_plain(a, b, m, f_int)
    _check("gf2_limb_multiply", m, f_int, a, b)
    return _multiply_launch(a, b, m, f_int)


def gf2_limb_square(a: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """K14's square: the kernel's square entry (bits spread, then the
    reduction), one pass counted in ``gf2_limb_multiply.launches``; CPU
    tensors take the plain version."""
    if a.device.type == "cpu":
        return gf2_limb_square_plain(a, m, f_int)
    _check("gf2_limb_square", m, f_int, a)
    return _multiply_launch(a, None, m, f_int)


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _multiply_launch(a, b, m: int, f_int: int) -> torch.Tensor:
    """The product a * b, or the square of a where b is None."""
    L = a.shape[0]
    if b is not None:
        a, b = align_planar(a, b)
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    else:
        shape = a.shape[1:]
    out = torch.empty((L,) + tuple(shape), dtype=torch.uint16, device=a.device)
    n = out[0].numel()
    if n:
        ta, ap, ae = _operand(a, L, shape)
        tb, bp, be = _operand(b, L, shape) if b is not None else (ta, ap, ae)
        fold, table = _fold(m, f_int, a.device)
        with torch.cuda.device(a.device):
            rc = _lib().gf2_limb_mul_launch(
                ta.data_ptr(), ap, ae, tb.data_ptr(), bp, be, out.data_ptr(), n, m, fold,
                None if table is None else table.data_ptr(), int(b is None), _stream(a),
            )
        if rc != 0:
            raise RuntimeError(f"gf2_limb_multiply: kernel launch failed with CUDA error {rc}.")
        gf2_limb_multiply.launches += 1
    return out


# the power kernel's entries (csrc/gf2_limb.cu): a public exponent's ladder,
# the Itoh-Tsujii reciprocal, j squares for a^(2^j), per-element exponent words
_LADDER, _INVERSE, _SQUARES, _WORDS = range(4)


def gf2_limb_power(a: torch.Tensor, e, m: int, f_int: int, nbits: int = 0) -> torch.Tensor:
    """K14's power entry: a^e for a public exponent ``e`` (a Python int
    below 2^640; a^0 = 1), or a**e for a list of int64 word tensors (62 bits
    a word, broadcast against a's elements; the low ``nbits`` bits count,
    0**0 = 1), the whole chain in one launch (counted in
    ``gf2_limb_power.launches``): the Itoh-Tsujii chain for e = 2^m - 2,
    j squares for e = 2^j, else a square-and-multiply ladder. CPU tensors
    take the plain version."""
    per_element = not isinstance(e, int)
    if a.device.type == "cpu" and (not per_element or all(w.device.type == "cpu" for w in e)):
        return gf2_limb_power_plain(a, e, m, f_int, nbits)
    _check("gf2_limb_power", m, f_int, a, *(e if per_element else ()))
    L = a.shape[0]
    if per_element:
        if nbits > 62 * len(e) or any(w.dtype != torch.int64 for w in e):
            raise TypeError(f"gf2_limb_power: needs int64 exponent words covering {nbits} bits.")
        shape = torch.broadcast_shapes(a.shape[1:], *(w.shape for w in e))
        words = torch.stack([w.expand(shape) for w in e]).reshape(len(e), -1).contiguous()
        a = a.reshape(a.shape[:1] + (1,) * (len(shape) - (a.ndim - 1)) + a.shape[1:])
        entry, ex = _WORDS, 0
    else:
        if not 0 <= e < 2 ** (64 * _EXP_WORDS):
            raise ValueError(f"gf2_limb_power: a public exponent must lie in [0, 2^{64 * _EXP_WORDS}), not {e}.")
        shape, words, ex = tuple(a.shape[1:]), None, e
        if e == 2**m - 2:
            entry, nbits = _INVERSE, 0
        elif e > 1 and e & (e - 1) == 0:
            entry, nbits = _SQUARES, e.bit_length() - 1
        else:
            entry, nbits = _LADDER, e.bit_length()
    out = torch.empty((L,) + tuple(shape), dtype=torch.uint16, device=a.device)
    n = out[0].numel()
    if n:
        ta, ap, ae = _operand(a, L, shape)
        fold, table = _fold(m, f_int, a.device)
        with torch.cuda.device(a.device):
            rc = _lib().gf2_limb_pow_launch(
                ta.data_ptr(), ap, ae, out.data_ptr(), n, m, fold, None if table is None else table.data_ptr(),
                entry, _words(ex), nbits, None if words is None else words.data_ptr(),
                0 if words is None else words.stride(0), 0 if words is None else words.stride(1), _stream(a),
            )
        if rc != 0:
            raise RuntimeError(f"gf2_limb_power: kernel launch failed with CUDA error {rc}.")
        gf2_limb_power.launches += 1
    return out


gf2_limb_multiply.launches = 0
gf2_limb_power.launches = 0
