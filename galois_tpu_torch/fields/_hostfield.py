"""Exact scalar field arithmetic on Python ints (host side, plan-build time).

Port of ``galois_tpu/fields/_hostfield.py``: any GF(p^m) with arbitrary
precision. Used by the NTT plans, the irreducibility and primitive-element
searches of ``GF()``, ``host_log``, the 'python-calculate' mode, the ufunc
methods that run on the host and the tests' exact checks. Elements are
in the integer representation (the base-p digits of the polynomial
representation).
"""

from __future__ import annotations

import functools
from typing import List

from ._meta import FieldMeta


class HostField:
    """Scalar GF(p^m) arithmetic over Python ints (integer representation)."""

    def __init__(self, meta: FieldMeta):
        self.meta = meta
        self.p = meta.characteristic
        self.m = meta.degree
        self.q = meta.order

    def to_coeffs(self, a: int) -> List[int]:
        """Int repr -> ascending base-p digit list of length m."""
        p, m = self.p, self.m
        return [(a // p**i) % p for i in range(m)]

    def from_coeffs(self, c: List[int]) -> int:
        p = self.p
        return sum((ci % p) * p**i for i, ci in enumerate(c))

    def add(self, a: int, b: int) -> int:
        if self.m == 1:
            return (a + b) % self.p
        if self.p == 2:
            return a ^ b
        ca, cb = self.to_coeffs(a), self.to_coeffs(b)
        return self.from_coeffs([(x + y) % self.p for x, y in zip(ca, cb)])

    def negative(self, a: int) -> int:
        if self.m == 1:
            return (-a) % self.p
        if self.p == 2:
            return a
        return self.from_coeffs([(-x) % self.p for x in self.to_coeffs(a)])

    def subtract(self, a: int, b: int) -> int:
        return self.add(a, self.negative(b))

    def multiply(self, a: int, b: int) -> int:
        p, m = self.p, self.m
        if m == 1:
            return (a * b) % p
        if p == 2:
            res = 0
            while b:
                if b & 1:
                    res ^= a
                a <<= 1
                b >>= 1
            f = self.meta.irreducible_poly_int
            for i in range(res.bit_length() - 1, m - 1, -1):
                if (res >> i) & 1:
                    res ^= f << (i - m)
            return res
        ca, cb = self.to_coeffs(a), self.to_coeffs(b)
        full = [0] * (2 * m - 1)
        for i, x in enumerate(ca):
            if x:
                for j, y in enumerate(cb):
                    full[i + j] = (full[i + j] + x * y) % p
        R = self.meta.reduction_matrix  # (m-1, m), rows ascending coeffs
        low = full[:m]
        for k in range(m - 1):
            h = full[m + k]
            if h:
                for j in range(m):
                    low[j] = (low[j] + h * int(R[k, j])) % p
        return self.from_coeffs(low)

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

    def divide(self, a: int, b: int) -> int:
        return self.multiply(a, self.reciprocal(b))

    def is_square(self, a: int) -> bool:
        if a == 0 or self.p == 2:
            return True
        return self.power(a, (self.q - 1) // 2) == 1

    def find_non_square(self) -> int:
        """A non-square element (odd q only): the primitive element, whose
        discrete log, 1, is odd."""
        if self.q % 2 == 0:
            raise RuntimeError("Every element of a characteristic-2 field is a square.")
        return self.meta.primitive_element_int

    def multiplicative_order(self, a: int) -> int:
        """Order of a in the unit group, via the factorization of q-1."""
        from ..nt import factors

        if a == 0:
            raise ArithmeticError("0 has no multiplicative order.")
        if a == 1:
            return 1
        n = self.q - 1
        primes, _ = factors(n)
        order = n
        for pi in primes:
            while order % pi == 0 and self.power(a, order // pi) == 1:
                order //= pi
        return order

    def is_primitive_element(self, a: int) -> bool:
        if a == 0:
            return False
        return self.multiplicative_order(a) == self.q - 1


@functools.lru_cache(maxsize=None)
def get_host_field(meta: FieldMeta) -> HostField:
    return HostField(meta)
