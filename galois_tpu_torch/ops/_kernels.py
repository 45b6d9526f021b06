"""Elementwise field arithmetic on storage tensors.

Port of the int-storage families of ``galois_tpu/ops/_kernels.py``:

- ``PrimeOps``      GF(p), p <= 2^32, int64 (or uint8) storage
- ``GF2Ops``        GF(2), bitwise
- ``BinaryExtOps``  GF(2^m), m <= 32; the multiply for m <= 16 is kernel K7
                    (``ops/_elementwise.py::gf2m_multiply``)

Every op takes and returns tensors in the field's storage dtype and keeps
its inputs' device. Arithmetic is widened to int64 inside each op: torch
has no unsigned 16/32-bit arithmetic, and uint8 sums wrap. ``LookupOps``,
``OddExtOps`` and the limb families are still to be ported.
"""

from __future__ import annotations

import functools

import torch

from ..fields._meta import FieldMeta
from ._elementwise import gf2m_multiply

__all__ = ["get_ops", "FieldOps", "mulmod"]


def mulmod(a, b, p: int):
    """(a * b) mod p for int64 tensors (b may be a Python int) holding values
    in [0, p), p < 2^32.

    int64 products overflow once (p - 1)^2 >= 2^63, which includes the NTT
    prime 3 * 2^30 + 1. Then b is split into 16-bit halves: a * b_hi and
    a * b_lo stay below 2^48, and so does (a * b_hi mod p) * 2^16."""
    if (p - 1) ** 2 < 2**63:
        return a * b % p
    b_hi, b_lo = b >> 16, b & 0xFFFF
    return ((a * b_hi) % p * 65536 + a * b_lo) % p


class FieldOps:
    """Base class: square-and-multiply powers and derived ops."""

    def __init__(self, meta: FieldMeta):
        self.meta = meta
        self.dt = meta.torch_dtype

    # subclasses: add, subtract, negative, multiply, reciprocal

    def square(self, a):
        return self.multiply(a, a)

    def divide(self, a, b):
        return self.multiply(a, self.reciprocal(b))

    def power_static(self, a, e: int):
        """a**e for a Python-int exponent (any size and sign)."""
        if e < 0:
            return self.power_static(self.reciprocal(a), -e)
        if e == 0:
            return self.one_like(a)
        result = None
        for bit in bin(e)[2:]:
            if result is not None:
                result = self.square(result)
            if bit == "1":
                result = a if result is None else self.multiply(result, a)
        return result

    def power(self, a, e, nbits: int):
        """a**e for a non-negative int64 exponent tensor below 2^nbits:
        a binary ladder over the exponent's bits (0**0 = 1)."""
        a, e = torch.broadcast_tensors(a, e)
        result = self.one_like(a)
        base = a
        for i in range(nbits):
            bit = ((e >> i) & 1).bool()
            result = torch.where(bit, self.multiply(result, base), result)
            if i + 1 < nbits:
                base = self.square(base)
        return result

    def one_like(self, a):
        return torch.ones_like(a)

    def is_zero(self, a):
        return a == 0


# ======================================================================
# GF(p), p <= 2^32
# ======================================================================

class PrimeOps(FieldOps):
    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic

    def add(self, a, b):
        s = a.to(torch.int64) + b.to(torch.int64)
        return torch.where(s >= self.p, s - self.p, s).to(self.dt)

    def negative(self, a):
        aw = a.to(torch.int64)
        return torch.where(aw == 0, aw, self.p - aw).to(self.dt)

    def subtract(self, a, b):
        d = a.to(torch.int64) - b.to(torch.int64)
        return torch.where(d < 0, d + self.p, d).to(self.dt)

    def multiply(self, a, b):
        return mulmod(a.to(torch.int64), b.to(torch.int64), self.p).to(self.dt)

    def reciprocal(self, a):
        return self.power_static(a, self.p - 2)


class GF2Ops(PrimeOps):
    """GF(2): pure bitwise ops."""

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        return a & b

    def reciprocal(self, a):
        return a

    def divide(self, a, b):
        return a & b

    def power(self, a, e, nbits: int):
        a, e = torch.broadcast_tensors(a, e)
        return torch.where(e == 0, torch.ones_like(a), a)

    def power_static(self, a, e: int):
        return torch.ones_like(a) if e == 0 else a


# ======================================================================
# GF(2^m), m <= 32
# ======================================================================

class BinaryExtOps(FieldOps):
    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.m = meta.degree
        self.f = meta.irreducible_poly_int
        # Reduction constant R = f - x^m: x^m = R (mod f), so folding the
        # overflow bits down is a constant carry-less multiply by R.
        R = self.f ^ (1 << self.m)
        self._r_bits = [k for k in range(R.bit_length()) if (R >> k) & 1]
        self._deg_r = max(self._r_bits) if self._r_bits else 0

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        if self.m <= 16:
            return gf2m_multiply(a, b, self.m, self.f)
        return self._reduce(self._clmul(a.to(torch.int64), b.to(torch.int64)))

    def _clmul(self, a, b):
        """Carry-less product of int64 tensors; 2m - 1 <= 63 bits."""
        acc = torch.zeros_like(a)
        for i in range(self.m):
            acc = acc ^ ((a << i) & -((b >> i) & 1))
        return acc

    def _reduce(self, c):
        """Reduce a carry-less product mod f by constant folds."""
        m = self.m
        width = 2 * m - 1
        while width > m:
            o = c >> m
            c = c & ((1 << m) - 1)
            for k in self._r_bits:
                c = c ^ (o << k)
            width = max(m, width - m + self._deg_r)
        return c.to(self.dt)

    def square(self, a):
        # Squaring spreads bit i to bit 2i, then reduces: linear in m.
        aw = a.to(torch.int64)
        acc = torch.zeros_like(aw)
        for i in range(self.m):
            acc = acc ^ (((aw >> i) & 1) << (2 * i))
        return self._reduce(acc)

    def reciprocal(self, a):
        # Itoh-Tsujii: a^(2^m - 2) = (a^(2^(m-1) - 1))^2 with an addition
        # chain on m - 1.
        t = a  # a^(2^1 - 1)
        k = 1
        for bit in bin(self.m - 1)[3:]:
            tk = t
            for _ in range(k):
                tk = self.square(tk)
            t = self.multiply(tk, t)
            k *= 2
            if bit == "1":
                t = self.multiply(self.square(t), a)
                k += 1
        return self.square(t)


@functools.lru_cache(maxsize=None)
def get_ops(meta: FieldMeta, mode: str):
    """Return the ops object for (field, mode). The port has 'jit-calculate'
    arithmetic only; the lookup-table mode waits for kernels K3-K6."""
    if mode != "jit-calculate":
        raise NotImplementedError(
            f"Mode {mode!r} is not ported yet (ROADMAP.md, queue 1 item 6)."
        )
    p, m = meta.characteristic, meta.degree
    if m == 1:
        return GF2Ops(meta) if p == 2 else PrimeOps(meta)
    if p == 2:
        return BinaryExtOps(meta)
    raise NotImplementedError(f"{meta.name}: OddExtOps is not ported yet (ROADMAP.md, queue 1 item 6).")
