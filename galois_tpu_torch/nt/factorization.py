"""Host-side integer factorization.

API parity with the reference library's `_prime.py` factorization half
(reference: src/galois/_prime.py:812-1682).  The pipeline in `factors()` is:
memoized cache -> primality -> perfect-power -> trial division -> Pollard rho
(Brent) with Pollard p-1 assists.
"""

from __future__ import annotations

import functools
import math
import random

from .basic import ilog, iroot, isqrt, prod
from .primality import is_prime, primes

__all__ = [
    "factors",
    "perfect_power",
    "trial_division",
    "pollard_p1",
    "pollard_rho",
    "divisors",
    "divisor_sigma",
    "is_prime_power",
    "is_perfect_power",
    "is_square_free",
    "is_smooth",
    "is_powersmooth",
]


def perfect_power(n: int) -> tuple[int, int]:
    """Decompose n = c^e with e maximal. Returns (n, 1) when n is not a perfect power."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n in (0, 1, -1):
        return n, 1
    sign = 1 if n > 0 else -1
    m = abs(n)
    base, exponent = m, 1
    # Try prime exponents only; composite exponents factor through primes.
    for p in primes(m.bit_length()):
        if sign < 0 and p == 2:
            continue  # negative numbers cannot be even powers
        root = iroot(m, p)
        if root**p == m:
            sub_base, sub_exp = perfect_power(sign * root)
            return sub_base, sub_exp * p
    return sign * base, exponent


def is_perfect_power(n: int) -> bool:
    """True if n == c^e for some integer c and e > 1 (with -1, 0, 1 perfect by convention)."""
    if n in (-1, 0, 1):
        return True  # -1 = (-1)^3, 0 = 0^2, 1 = 1^3
    return perfect_power(n)[1] > 1


def trial_division(n: int, B: int | None = None) -> tuple[list[int], list[int], int]:
    """Trial-divide n by primes <= B. Returns (primes, exponents, remaining_cofactor)."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    B = isqrt(n) if B is None else min(B, isqrt(n) + 1)
    if not isinstance(B, int):
        raise TypeError(f"Argument 'B' must be an integer, not {type(B)}.")
    p_list, e_list = [], []
    for p in primes(B):
        if n % p == 0:
            e = 0
            while n % p == 0:
                n //= p
                e += 1
            p_list.append(p)
            e_list.append(e)
        if n == 1:
            break
    return p_list, e_list, n


def pollard_p1(n: int, B: int, B2: int | None = None) -> int:
    """Pollard p-1 factorization with smoothness bound B (optional stage-2 bound B2).

    Returns a non-trivial factor, or raises RuntimeError if none is found.
    """
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 2:
        raise ValueError(f"Argument 'n' must be at least 2, not {n}.")
    a = 2
    for p in primes(B):
        a = pow(a, p ** ilog(B, p), n)
    d = math.gcd(a - 1, n)
    if 1 < d < n:
        return d
    if d == n:
        raise RuntimeError(f"Pollard p-1 failed to find a factor of {n} with B={B}.")
    if B2 is not None:
        # Stage 2: single large prime in (B, B2].
        for q in primes(B2):
            if q <= B:
                continue
            d = math.gcd(pow(a, q, n) - 1, n)
            if 1 < d < n:
                return d
    raise RuntimeError(f"Pollard p-1 failed to find a factor of {n} with B={B}, B2={B2}.")


def pollard_rho(n: int, c: int = 1) -> int:
    """Pollard rho (Brent's cycle detection) with polynomial x^2 + c.

    Returns a non-trivial factor, or raises RuntimeError on cycle failure.
    """
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 2:
        raise ValueError(f"Argument 'n' must be at least 2, not {n}.")
    if n % 2 == 0:
        return 2
    y, m = 2, 128
    g = q = r = 1
    x = ys = 0
    while g == 1:
        x = y
        for _ in range(r):
            y = (y * y + c) % n
        k = 0
        while k < r and g == 1:
            ys = y
            for _ in range(min(m, r - k)):
                y = (y * y + c) % n
                q = (q * abs(x - y)) % n
            g = math.gcd(q, n)
            k += m
        r *= 2
    if g == n:
        # Back up and walk one step at a time.
        g = 1
        while g == 1:
            ys = (ys * ys + c) % n
            g = math.gcd(abs(x - ys), n)
    if g == n:
        raise RuntimeError(f"Pollard rho failed to find a factor of {n} with c={c}.")
    return g


# Memoized factorizations of "famous" numbers that Pollard rho struggles with.
# These are public mathematical constants (Cunningham-project style entries for
# the fields exercised by the test suite), not code.
_KNOWN_FACTORIZATIONS: dict[int, list[int]] = {}


def _factor_recursive(n: int, out: list[int], rng: random.Random) -> None:
    """Append the prime factorization of n (>1) to `out`."""
    if n == 1:
        return
    if is_prime(n):
        out.append(n)
        return
    if n in _KNOWN_FACTORIZATIONS:
        out.extend(_KNOWN_FACTORIZATIONS[n])
        return
    base, exp = perfect_power(n)
    if exp > 1:
        sub: list[int] = []
        _factor_recursive(base, sub, rng)
        out.extend(sub * exp)
        return
    # Pollard rho with retry on different constants.
    c = 1
    while True:
        try:
            d = pollard_rho(n, c=c)
            break
        except RuntimeError:
            c = rng.randrange(1, n - 1)
    _factor_recursive(d, out, rng)
    _factor_recursive(n // d, out, rng)


@functools.lru_cache(maxsize=4096)
def _factors_cached(n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    # The Cunningham-style table of b^k +- 1 first, as the JAX package does:
    # many of its entries hold two primes above 10^15 (2^122 - 1, 2^128 + 1)
    # that Pollard rho cannot split in any reasonable time, and the group
    # orders 2^m - 1 of large binary fields are such numbers. An entry's
    # residual composite goes on through trial division and rho.
    from .._databases import PrimeFactorsDatabase

    db = PrimeFactorsDatabase()
    db_p: list[int] = []
    db_e: list[int] = []
    if n in db:
        db_p, db_e, n = db.fetch(n)
        if n == 1:
            order = sorted(range(len(db_p)), key=lambda i: db_p[i])
            return tuple(db_p[i] for i in order), tuple(db_e[i] for i in order)

    p_list, e_list, cofactor = trial_division(n, B=min(100_000, isqrt(n) + 1))
    if cofactor > 1:
        rest: list[int] = []
        _factor_recursive(cofactor, rest, random.Random(n))
        rest.sort()
        for p in rest:
            if p_list and p_list[-1] == p:
                e_list[-1] += 1
            else:
                p_list.append(p)
                e_list.append(1)
    if db_p:
        merged: dict[int, int] = {}
        for p, e in [*zip(db_p, db_e), *zip(p_list, e_list)]:
            merged[p] = merged.get(p, 0) + e
        ps = sorted(merged)
        return tuple(ps), tuple(merged[p] for p in ps)
    return tuple(p_list), tuple(e_list)


def factors(n: int) -> tuple[list[int], list[int]]:
    """Prime factorization of n: returns (sorted primes, exponents)."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return [1], [1]
    p, e = _factors_cached(n)
    return list(p), list(e)


def divisors(n: int) -> list[int]:
    """All positive divisors of n, ascending."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    n = abs(n)
    if n == 0:
        return []
    if n == 1:
        return [1]
    p_list, e_list = factors(n)
    if p_list == [1]:
        return [1]
    divs = [1]
    for p, e in zip(p_list, e_list):
        divs = [d * p**k for d in divs for k in range(e + 1)]
    return sorted(divs)


def divisor_sigma(n: int, k: int = 1) -> int:
    """Sum of the k-th powers of the divisors of n."""
    if not isinstance(n, int) or not isinstance(k, int):
        raise TypeError("Arguments must be integers.")
    d = divisors(n)
    if not d:
        raise ValueError(f"Argument 'n' must be nonzero, not {n}.")
    if k == 0:
        return len(d)
    return sum(x**k for x in d)


def is_prime_power(n: int) -> bool:
    """True if n == p^k for a prime p and k >= 1."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 2:
        return False
    if is_prime(n):
        return True
    base, exp = perfect_power(n)
    return exp > 1 and is_prime(base)


def is_square_free(n: int) -> bool:
    """True if no square divides n."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    n = abs(n)
    if n == 0:
        return False
    if n == 1:
        return True
    _, e_list = factors(n)
    return all(e == 1 for e in e_list)


def is_smooth(n: int, B: int) -> bool:
    """True if all prime factors of n are <= B."""
    if not isinstance(n, int) or not isinstance(B, int):
        raise TypeError("Arguments must be integers.")
    if B < 2:
        raise ValueError(f"Argument 'B' must be at least 2, not {B}.")
    n = abs(n)
    if n == 0:
        return False
    if n == 1:
        return True
    _, _, cofactor = trial_division(n, B)
    # trial_division caps the bound at sqrt(n); any remaining cofactor is prime.
    return cofactor == 1 or cofactor <= B


def is_powersmooth(n: int, B: int) -> bool:
    """True if every prime-power factor p^e of n satisfies p^e <= B."""
    if not isinstance(n, int) or not isinstance(B, int):
        raise TypeError("Arguments must be integers.")
    if B < 2:
        raise ValueError(f"Argument 'B' must be at least 2, not {B}.")
    n = abs(n)
    if n == 0:
        return False
    if n == 1:
        return True
    p_list, e_list, cofactor = trial_division(n, B)
    if cofactor != 1 and cofactor > B:
        return False  # leftover cofactor is prime (> sqrt bound), needs cofactor^1 <= B
    return all(p**e <= B for p, e in zip(p_list, e_list))
