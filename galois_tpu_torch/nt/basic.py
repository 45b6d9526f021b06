"""Host-side integer math primitives (arbitrary precision).

These run on the host at field-construction / plan-build time only; they
never execute on the device.  API parity with the reference library's `_math.py`
(reference: src/galois/_math.py:18-225).
"""

from __future__ import annotations

import math

__all__ = ["gcd", "egcd", "lcm", "prod", "isqrt", "iroot", "ilog"]


def gcd(a: int, b: int) -> int:
    """Greatest common divisor of two integers."""
    if not isinstance(a, (int,)) or not isinstance(b, (int,)):
        raise TypeError(f"Arguments must be integers, not {type(a)} and {type(b)}.")
    return math.gcd(a, b)


def egcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended Euclidean algorithm: returns (d, s, t) with a*s + b*t = d = gcd(a, b)."""
    if not isinstance(a, int) or not isinstance(b, int):
        raise TypeError(f"Arguments must be integers, not {type(a)} and {type(b)}.")
    r0, r1 = a, b
    s0, s1 = 1, 0
    t0, t1 = 0, 1
    while r1 != 0:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        s0, s1 = s1, s0 - q * s1
        t0, t1 = t1, t0 - q * t1
    # Normalize so the gcd is non-negative.
    if r0 < 0:
        r0, s0, t0 = -r0, -s0, -t0
    return r0, s0, t0


def lcm(*args: int) -> int:
    """Least common multiple of all arguments."""
    result = 1
    for v in args:
        if not isinstance(v, int):
            raise TypeError(f"Arguments must be integers, not {type(v)}.")
        result = math.lcm(result, v)
    return result


def prod(*args: int) -> int:
    """Product of all arguments."""
    result = 1
    for v in args:
        if not isinstance(v, int):
            raise TypeError(f"Arguments must be integers, not {type(v)}.")
        result *= v
    return result


def isqrt(n: int) -> int:
    """Integer square root: floor(sqrt(n))."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 0:
        raise ValueError(f"Argument 'n' must be non-negative, not {n}.")
    return math.isqrt(n)


def iroot(n: int, k: int) -> int:
    """Integer k-th root: floor(n ** (1/k))."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if not isinstance(k, int):
        raise TypeError(f"Argument 'k' must be an integer, not {type(k)}.")
    if n < 0:
        raise ValueError(f"Argument 'n' must be non-negative, not {n}.")
    if k < 1:
        raise ValueError(f"Argument 'k' must be at least 1, not {k}.")
    if n in (0, 1) or k == 1:
        return n
    if k == 2:
        return math.isqrt(n)
    # Newton's method on integers, seeded from a float/bit-length estimate.
    x = 1 << ((n.bit_length() + k - 1) // k)  # upper-ish bound of the root
    while True:
        y = ((k - 1) * x + n // x ** (k - 1)) // k
        if y >= x:
            break
        x = y
    while x**k > n:
        x -= 1
    return x


def ilog(n: int, b: int) -> int:
    """Integer logarithm: floor(log_b(n))."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if not isinstance(b, int):
        raise TypeError(f"Argument 'b' must be an integer, not {type(b)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if b < 2:
        raise ValueError(f"Argument 'b' must be at least 2, not {b}.")
    # Exponential-then-binary search on the exponent; exact for big ints.
    lo, hi = 0, 1
    while b**hi <= n:
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if b**mid <= n:
            lo = mid
        else:
            hi = mid
    return lo
