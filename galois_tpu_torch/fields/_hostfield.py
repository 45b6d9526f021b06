"""Exact scalar field arithmetic on Python ints (host side, plan-build time).

Port of ``galois_tpu/fields/_hostfield.py`` for the field kinds the port has:
GF(p) and GF(2^m). Used by ``_get_omega``, NTT plan construction and the
primitive-element check. Elements are in the integer representation.
"""

from __future__ import annotations

import functools

from ._meta import FieldMeta


class HostField:
    """Scalar GF(p) / GF(2^m) arithmetic over Python ints."""

    def __init__(self, meta: FieldMeta):
        if meta.degree > 1 and meta.characteristic != 2:
            raise NotImplementedError(
                f"{meta.name}: odd-characteristic extension fields are not ported yet "
                "(ROADMAP.md, queue 1 item 6)."
            )
        self.meta = meta
        self.p = meta.characteristic
        self.m = meta.degree
        self.q = meta.order

    def multiply(self, a: int, b: int) -> int:
        if self.m == 1:
            return (a * b) % self.p
        res = 0
        while b:
            if b & 1:
                res ^= a
            a <<= 1
            b >>= 1
        f = self.meta.irreducible_poly_int
        for i in range(res.bit_length() - 1, self.m - 1, -1):
            if (res >> i) & 1:
                res ^= f << (i - self.m)
        return res

    def power(self, a: int, e: int) -> int:
        if e < 0:
            return self.power(self.reciprocal(a), -e)
        if self.m == 1:
            return pow(a, e, self.p)
        result = 1
        base = a
        while e:
            if e & 1:
                result = self.multiply(result, base)
            base = self.multiply(base, base)
            e >>= 1
        return result

    def reciprocal(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("Cannot invert 0.")
        if self.m == 1:
            return pow(a, -1, self.p)
        return self.power(a, self.q - 2)


@functools.lru_cache(maxsize=None)
def get_host_field(meta: FieldMeta) -> HostField:
    return HostField(meta)
