"""Host-side multiplicative number theory: totients, primitive roots, CRT.

API parity with the reference library's `_modular.py` and
`_primitive_root.py` (reference: src/galois/_modular.py:16-475,
src/galois/_primitive_root.py:18-467).
"""

from __future__ import annotations

import math
import random
from typing import Iterator, Literal, Sequence

from .basic import egcd, prod
from .factorization import factors
from .primality import is_prime

__all__ = [
    "totatives",
    "euler_phi",
    "mobius",
    "carmichael_lambda",
    "is_cyclic",
    "is_primitive_root",
    "primitive_root",
    "primitive_roots",
    "crt",
]


def totatives(n: int) -> list[int]:
    """All integers in [1, n) coprime to n (for n == 1, returns [0])."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return [0]
    return [t for t in range(1, n) if math.gcd(t, n) == 1]


def euler_phi(n: int) -> int:
    """Euler's totient: count of integers in [1, n] coprime to n."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return 1
    p_list, e_list = factors(n)
    result = 1
    for p, e in zip(p_list, e_list):
        result *= p ** (e - 1) * (p - 1)
    return result


def mobius(n: int) -> int:
    """Mobius function: 0 if square-divisible, else (-1)^(number of prime factors)."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return 1
    p_list, e_list = factors(n)
    if any(e > 1 for e in e_list):
        return 0
    return (-1) ** len(p_list)


def carmichael_lambda(n: int) -> int:
    """Carmichael function: exponent of the multiplicative group (Z/nZ)^x."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return 1
    p_list, e_list = factors(n)
    lambdas = []
    for p, e in zip(p_list, e_list):
        if p == 2 and e >= 3:
            lambdas.append(2 ** (e - 2))
        else:
            lambdas.append(p ** (e - 1) * (p - 1))
    return math.lcm(*lambdas)


def is_cyclic(n: int) -> bool:
    """True if (Z/nZ)^x is cyclic, i.e. n in {1, 2, 4, p^k, 2 p^k} for odd prime p."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n in (1, 2, 4):
        return True
    p_list, e_list = factors(n)
    if p_list[0] == 2:
        return e_list[0] == 1 and len(p_list) == 2
    return len(p_list) == 1


def is_primitive_root(g: int, n: int) -> bool:
    """True if g generates (Z/nZ)^x."""
    if not isinstance(g, int) or not isinstance(n, int):
        raise TypeError("Arguments must be integers.")
    if n < 1:
        raise ValueError(f"Argument 'n' must be at least 1, not {n}.")
    if n == 1:
        return g % n == 0
    if n == 2:
        return g % n == 1
    g %= n
    if math.gcd(g, n) != 1:
        return False
    phi = euler_phi(n)
    lam = carmichael_lambda(n)
    if lam != phi:
        return False  # group not cyclic, no primitive roots exist
    return all(pow(g, phi // q, n) != 1 for q in factors(phi)[0])


def _search_range(n: int, start: int, stop: int | None) -> tuple[int, int]:
    stop = n if stop is None else stop
    if not 1 <= start < stop <= n:
        raise ValueError(f"Search range [{start}, {stop}) must lie within [1, {n}).")
    return start, stop


def primitive_root(
    n: int,
    start: int = 1,
    stop: int | None = None,
    method: Literal["min", "max", "random"] = "min",
) -> int:
    """Find a primitive root of n in [start, stop). Raises RuntimeError if none exists."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if method not in ("min", "max", "random"):
        raise ValueError(f"Argument 'method' must be 'min', 'max', or 'random', not {method!r}.")
    if n in (1, 2):
        return n - 1
    start, stop = _search_range(n, start, stop)
    if not is_cyclic(n):
        raise RuntimeError(f"{n} has no primitive roots: (Z/{n}Z)^x is not cyclic.")
    if method == "min":
        for g in range(start, stop):
            if is_primitive_root(g, n):
                return g
    elif method == "max":
        for g in range(stop - 1, start - 1, -1):
            if is_primitive_root(g, n):
                return g
    else:
        rng = random.Random()
        while True:
            g = rng.randrange(start, stop)
            if is_primitive_root(g, n):
                return g
    raise RuntimeError(f"No primitive root of {n} exists in [{start}, {stop}).")


def primitive_roots(
    n: int,
    start: int = 1,
    stop: int | None = None,
    reverse: bool = False,
) -> Iterator[int]:
    """Iterate all primitive roots of n in [start, stop)."""
    if not isinstance(n, int):
        raise TypeError(f"Argument 'n' must be an integer, not {type(n)}.")
    if n in (1, 2):
        yield n - 1
        return
    start, stop = _search_range(n, start, stop)
    if not is_cyclic(n):
        return
    rng = range(stop - 1, start - 1, -1) if reverse else range(start, stop)
    for g in rng:
        if is_primitive_root(g, n):
            yield g


def crt(remainders: Sequence[int], moduli: Sequence[int]) -> int:
    """Chinese remainder theorem for pairwise-compatible congruences x = r_i (mod m_i)."""
    if len(remainders) != len(moduli):
        raise ValueError("Arguments 'remainders' and 'moduli' must have equal length.")
    x, m = 0, 1
    for r_i, m_i in zip(remainders, moduli):
        d, s, _ = egcd(m, m_i)
        if (r_i - x) % d != 0:
            raise ValueError(
                f"Congruences x = {r_i} (mod {m_i}) and x = {x} (mod {m}) are inconsistent."
            )
        lcm_ = m // d * m_i
        x = (x + (r_i - x) // d * s % (m_i // d) * m) % lcm_
        m = lcm_
    return x % m
