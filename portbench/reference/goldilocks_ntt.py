"""The plain Goldilocks NTT and low-degree extension, in plain torch.

The yardstick that decides an ``ntt_lde`` cell's ``correct``. The field is
GF(p), p = 2^64 - 2^32 + 1, written from its definition: an element is a
pair ``(hi, lo)`` of int64 tensors holding its 32-bit halves, value
hi 2^32 + lo, canonical in [0, p). A product is taken in 16-bit pieces
(piece products below 2^32, column sums below 2^35), carried into the four
32-bit words r0..r3 of the 128-bit product, and reduced with
2^64 = 2^32 - 1 and 2^96 = -1 (mod p):

    r0 + r1 2^32 + r2 2^64 + r3 2^96 = (r1 2^32 + r0) + r2 (2^32 - 1) - r3.

The transform is the iterative radix-2 NTT over the trailing axis: a
bit-reversal permutation, then log2(N) stages of butterflies
(u, v) -> (u + w v, u - w v). Its conventions are NumPy's: the forward
transform X[k] = sum_n x[n] w^(nk) with w = g^((p - 1) / N) for the
multiplicative generator g, unscaled; the inverse takes w^-1 and scales by
1/N. The low-degree extension of a column of N values onto the coset
shift * <w_(bN)> is ``fft(ifft(x) * shift^i, n=bN)``, one column at a time
so that a column of 2^23 fits beside its temporaries. It runs on any device
and imports nothing outside torch.

The control (``lossy_mul``) rounds both operands of every butterfly's
product to the significand of a float precision (53 bits for float64, the
nearest below the exact 64-bit arithmetic the configuration states; fewer
for the narrower types), in float64's range, before the exact product.
"""

from __future__ import annotations

import math

import torch

__all__ = ["P", "from_int", "to_int", "add", "sub", "mul", "significand_bits", "lossy_mul", "powers", "ntt", "lde",
           "split_limbs", "join_limbs"]

P = 2**64 - 2**32 + 1
_M32 = 2**32 - 1
_M16 = 2**16 - 1


def from_int(v: int, device="cpu"):
    """A host int in [0, p) as a pair of 0-d tensors."""
    return torch.tensor(v >> 32, device=device), torch.tensor(v & _M32, device=device)


def to_int(a) -> list:
    """A pair of 1-d tensors as host ints (for tests)."""
    return [(h << 32) | lo for h, lo in zip(a[0].tolist(), a[1].tolist())]


def _carry(hi, lo):
    """(hi, lo) with lo moved into [0, 2^32) and its carry or borrow into hi."""
    return hi + (lo >> 32), lo & _M32


def _sub_p_if_ge(hi, lo):
    """A value in [0, 2p) with lo in [0, 2^32) -> its residue."""
    ge = (hi > _M32) | ((hi == _M32) & (lo >= 1))
    h, low = _carry(hi - _M32, lo - 1)  # minus p = (2^32 - 1) 2^32 + 1
    return torch.where(ge, h, hi), torch.where(ge, low, lo)


def add(a, b):
    hi, lo = _carry(a[0] + b[0], a[1] + b[1])
    return _sub_p_if_ge(hi, lo)


def sub(a, b):
    hi, lo = _carry(a[0] - b[0], a[1] - b[1])
    neg = hi < 0
    h, low = _carry(hi + _M32, lo + 1)  # plus p
    return torch.where(neg, h, hi), torch.where(neg, low, lo)


def mul(a, b):
    """a b mod p, in 16-bit pieces."""
    x = (a[1] & _M16, a[1] >> 16, a[0] & _M16, a[0] >> 16)
    y = (b[1] & _M16, b[1] >> 16, b[0] & _M16, b[0] >> 16)
    digits, t = [], 0
    for k in range(7):
        for i in range(max(0, k - 3), min(3, k) + 1):
            t = t + x[i] * y[k - i]
        digits.append(t & _M16)
        t = t >> 16
    digits.append(t)  # below 2^16: the product is below 2^128
    r0, r1, r2, r3 = (digits[2 * w] | (digits[2 * w + 1] << 16) for w in range(4))
    low = _sub_p_if_ge(r1, r0)  # r1 2^32 + r0 < 2^64 < 2p
    low = sub(low, (torch.zeros_like(r3), r3))
    pos = (r2 > 0).to(r2.dtype)
    return add(low, (r2 - pos, (2**32 - r2) & _M32))  # r2 (2^32 - 1) = (r2 - 1) 2^32 + (2^32 - r2)


def significand_bits(precision: str) -> int:
    """The significand's width in bits, the hidden bit included, of a torch
    float dtype by name, or of TF32 ("tfloat32", float32's range with
    float16's significand)."""
    dtype = torch.float16 if precision == "tfloat32" else getattr(torch, precision, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"{precision!r} is not a float precision")
    return 2 - math.frexp(torch.finfo(dtype).eps)[1]  # eps = 2^(1 - bits) = 0.5 * 2^(2 - bits)


def lossy_mul(precision: str = "float64"):
    """``mul`` with both operands first rounded to the significand width of
    ``precision`` (``significand_bits``) in float64's range, where every
    element of the field is finite: the control."""
    bits = significand_bits(precision)

    def rounded(a):
        m, e = torch.frexp(a[0].to(torch.float64) * 2.0**32 + a[1].to(torch.float64))  # m in [0.5, 1)
        v = torch.ldexp(torch.round(m * 2.0**bits), e - bits)  # at most 2^64 < 2p
        hi = torch.floor(v / 2.0**32)
        return _sub_p_if_ge(hi.to(torch.int64), (v - hi * 2.0**32).to(torch.int64))

    def lossy(a, b):
        return mul(rounded(a), rounded(b))

    return lossy


def powers(g: int, n: int, device="cpu"):
    """g^0 .. g^(n-1) as a pair of (n,) tensors, by doubling the filled prefix."""
    hi = torch.zeros(1, dtype=torch.int64, device=device)
    lo = torch.ones(1, dtype=torch.int64, device=device)
    step = g % P  # g^(filled)
    while hi.shape[0] < n:
        nh, nl = mul((hi, lo), from_int(step, device))
        hi, lo = torch.cat([hi, nh])[:n], torch.cat([lo, nl])[:n]
        step = step * step % P
    return hi[:n], lo[:n]


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    rev = torch.zeros_like(i)
    for b in range(bits):
        rev |= ((i >> b) & 1) << (bits - 1 - b)
    return rev


def root_of_unity(n: int, generator: int, inverse: bool = False) -> int:
    if (P - 1) % n:
        raise ValueError(f"{n} does not divide p - 1")
    w = pow(generator, (P - 1) // n, P)
    return pow(w, P - 2, P) if inverse else w


def ntt(x, generator: int, inverse: bool = False, butterfly_mul=mul):
    """The NTT of the trailing axis of x = (hi, lo), N a power of 2; the
    inverse scales by 1/N."""
    hi, lo = x
    n = hi.shape[-1]
    if n & (n - 1):
        raise ValueError(f"N = {n} is not a power of 2")
    dev, batch = hi.device, hi.shape[:-1]
    tw = powers(root_of_unity(n, generator, inverse), max(1, n // 2), dev)
    rev = _bit_reverse(n, dev)
    hi, lo = hi[..., rev], lo[..., rev]
    half = 1
    while half < n:
        shape = batch + (n // (2 * half), 2, half)
        h, low = hi.reshape(shape), lo.reshape(shape)
        w = (tw[0][:: n // (2 * half)], tw[1][:: n // (2 * half)])  # w_(2 half)^j, j < half
        u = (h[..., 0, :], low[..., 0, :])
        v = butterfly_mul((h[..., 1, :], low[..., 1, :]), w)
        top, bot = add(u, v), sub(u, v)
        hi = torch.stack([top[0], bot[0]], dim=-2).reshape(batch + (n,))
        lo = torch.stack([top[1], bot[1]], dim=-2).reshape(batch + (n,))
        half *= 2
    if inverse:
        hi, lo = mul((hi, lo), from_int(pow(n, P - 2, P), dev))
    return hi, lo


def lde(cols, generator: int, shift: int, blowup: int, butterfly_mul=mul):
    """The coset low-degree extension of each row of cols = (hi, lo), (C, N):
    ``fft(ifft(x) * shift^i, n=blowup N)``, a row at a time -> (C, blowup N)."""
    hi, lo = cols
    C, n = hi.shape
    coset = powers(shift, n, hi.device)
    out_hi = torch.empty((C, blowup * n), dtype=torch.int64, device=hi.device)
    out_lo = torch.empty_like(out_hi)
    for c in range(C):
        coeffs = mul(ntt((hi[c], lo[c]), generator, inverse=True, butterfly_mul=butterfly_mul), coset)
        pad = torch.zeros((blowup - 1) * n, dtype=torch.int64, device=hi.device)
        out_hi[c], out_lo[c] = ntt((torch.cat([coeffs[0], pad]), torch.cat([coeffs[1], pad])), generator,
                                   butterfly_mul=butterfly_mul)
    return out_hi, out_lo


def split_limbs(a) -> torch.Tensor:
    """(hi, lo) -> the little-endian 16-bit limbs (4, ...), int64."""
    return torch.stack([a[1] & _M16, a[1] >> 16, a[0] & _M16, a[0] >> 16])


def join_limbs(limbs: torch.Tensor):
    """Little-endian 16-bit limbs (4, ...) -> (hi, lo), int64."""
    w = limbs.to(torch.int64)
    return w[2] | (w[3] << 16), w[0] | (w[1] << 16)
