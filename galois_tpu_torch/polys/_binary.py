"""GF(2)[x] packed-integer kernels.

Port of ``galois_tpu/polys/_binary.py``, unchanged in behaviour. A GF(2)
polynomial is ONE Python int: bit d holds the coefficient of x^d.
All arithmetic is big-int bit-twiddling, so a degree-10^5 multiply is a few
thousand word ops instead of 10^10 coefficient ops. This is the hot path for
the high-degree GF(2) irreducible/primitive polynomial searches.

Reference semantics: src/galois/_polys/_binary.py:8-121 (independent
implementation: multiply iterates the sparser operand's set bits; squaring
spreads 16-bit chunks through a precomputed table; divmod is shift-XOR long
division).
"""

from __future__ import annotations

__all__ = [
    "add",
    "multiply",
    "square",
    "divmod_",
    "gcd",
    "mod",
    "pow_",
    "pow_mod",
    "reverse",
]


def add(a: int, b: int) -> int:
    """Addition == subtraction == XOR in GF(2)[x]."""
    return a ^ b


def multiply(a: int, b: int) -> int:
    """Carry-less product: XOR of `a` shifted to each set bit of `b`."""
    if a == 0 or b == 0:
        return 0
    if a == b:
        return square(a)
    if a.bit_count() < b.bit_count():
        a, b = b, a
    acc = 0
    while b:
        lsb = b & -b
        acc ^= a << (lsb.bit_length() - 1)
        b ^= lsb
    return acc


_SPREAD16: list | None = None


def _spread_table() -> list:
    """spread(v): bit k of v -> bit 2k, for all 16-bit v (squaring kernel)."""
    global _SPREAD16
    if _SPREAD16 is None:
        table = [0] * (1 << 16)
        for v in range(1, 1 << 16):
            lsb = v & -v
            # spread(v) = spread(v - lsb) | lsb^2   (lsb^2 == bit moved to 2k)
            table[v] = table[v ^ lsb] | (lsb * lsb)
        _SPREAD16 = table
    return _SPREAD16


def square(a: int) -> int:
    """f(x)^2 = f(x^2) in characteristic 2: interleave zeros between bits."""
    t = _spread_table()
    acc = 0
    shift = 0
    while a:
        chunk = t[a & 0xFFFF]
        if chunk:
            acc |= chunk << shift
        a >>= 16
        shift += 32
    return acc


def divmod_(a: int, b: int) -> tuple:
    """Shift-XOR long division: returns (quotient, remainder)."""
    if b == 0:
        raise ZeroDivisionError("Cannot divide a polynomial by zero.")
    db = b.bit_length() - 1
    q = 0
    r = a
    dr = r.bit_length() - 1
    while r and dr >= db:
        shift = dr - db
        q |= 1 << shift
        r ^= b << shift
        dr = r.bit_length() - 1
    return q, r


def mod(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("Cannot divide a polynomial by zero.")
    db = b.bit_length() - 1
    r = a
    dr = r.bit_length() - 1
    while r and dr >= db:
        r ^= b << (dr - db)
        dr = r.bit_length() - 1
    return r


def pow_(base: int, e: int) -> int:
    """base(x)^e by square-and-multiply."""
    result = 1
    while e:
        if e & 1:
            result = multiply(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def pow_mod(base: int, e: int, modulus: int) -> int:
    """base(x)^e mod modulus(x) — the Rabin-test workhorse."""
    result = 1
    base = mod(base, modulus)
    while e:
        if e & 1:
            result = mod(multiply(result, base), modulus)
        e >>= 1
        if e:
            base = mod(square(base), modulus)
    return result


def gcd(a: int, b: int) -> int:
    """Euclidean gcd; every nonzero GF(2)[x] poly is monic, so the last
    nonzero remainder is THE monic gcd."""
    while b:
        a, b = b, mod(a, b)
    return a


def reverse(a: int) -> int:
    """x^deg * f(1/x): bit-reverse within the polynomial's bit length."""
    if a == 0:
        return 0
    return int(bin(a)[2:][::-1], 2)
