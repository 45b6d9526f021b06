"""Polynomial factorization over GF(p^m).

Port of ``galois_tpu/polys/_factor.py``, unchanged in behaviour: square-free
(Yun), distinct-degree and equal-degree (Cantor-Zassenhaus) factorization,
composed into ``factors()``, on the exact host layer (``polys/_hostpoly.py``).
The factors come back sorted by their integer representation, so the random
splits of the equal-degree stage do not show in any result.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from . import _hostpoly as hp
from ._poly import Poly, _hf

__all__ = [
    "square_free_factors",
    "distinct_degree_factors",
    "equal_degree_factors",
    "factors",
    "is_square_free",
]


def _monic(F, f):
    if f == [0]:
        return f
    return hp.scalar_mul(F, f, F.reciprocal(f[-1]))


def square_free_factors(poly: Poly) -> Tuple[List[Poly], List[int]]:
    """Yun's algorithm adapted to characteristic p."""
    if poly.degree < 1:
        raise ValueError("The polynomial must have degree >= 1.")
    field = poly.field
    F = _hf(field)
    p = field.characteristic
    m_exp = field.order // p  # q/p = p^(m-1): coefficient p-th roots are c^(q/p)

    f = _monic(F, poly._asc())
    factors_, multiplicities = [], []

    d = hp.derivative(F, f)
    if hp.trim(d) != [0]:
        c = hp.gcd(F, f, d)
        w = hp.divmod_(F, f, c)[0]
        i = 1
        while hp.degree(w) > 0:
            y = hp.gcd(F, w, c)
            z = hp.divmod_(F, w, y)[0]
            if hp.degree(z) > 0:
                factors_.append(z)
                multiplicities.append(i)
            w = y
            c = hp.divmod_(F, c, y)[0]
            i += 1
    else:
        c = f

    if hp.degree(c) > 0:
        # c(x) = g(x^p): take the p-th root of each coefficient
        root = [F.power(c[j] if j < len(c) else 0, m_exp) for j in range(0, hp.degree(c) + 1, p)]
        sub_factors, sub_mults = square_free_factors(Poly._from_asc(root, field))
        for sf, sm in zip(sub_factors, sub_mults):
            factors_.append(sf._asc())
            multiplicities.append(sm * p)

    polys = [Poly._from_asc(fa, field) for fa in factors_]
    order = sorted(range(len(polys)), key=lambda k: int(polys[k]))
    return [polys[k] for k in order], [multiplicities[k] for k in order]


def distinct_degree_factors(poly: Poly) -> Tuple[List[Poly], List[int]]:
    """Split a square-free polynomial into products of irreducibles of equal
    degree."""
    field = poly.field
    F = _hf(field)
    q = field.order
    f = _monic(F, poly._asc())
    n = hp.degree(f)

    factors_, degrees = [], []
    h = [0, 1]  # x
    d = 1
    while n >= 2 * d:
        h = hp.pow_mod(F, h, q, f)
        g = hp.gcd(F, f, hp.sub(F, h, [0, 1]))
        if hp.degree(g) > 0:
            factors_.append(g)
            degrees.append(d)
            f = hp.divmod_(F, f, g)[0]
            h = hp.mod(F, h, f)
            n = hp.degree(f)
        d += 1
    if n > 0:
        factors_.append(f)
        degrees.append(n)
    return [Poly._from_asc(fa, field) for fa in factors_], degrees


def equal_degree_factors(poly: Poly, degree: int, rng: Optional[random.Random] = None) -> List[Poly]:
    """Cantor-Zassenhaus: factor a square-free product of irreducibles of
    degree ``degree`` into those irreducibles. ``rng`` draws the random
    splitting polynomials; by default one seeded from the polynomial."""
    field = poly.field
    F = _hf(field)
    q = field.order
    d = int(degree)
    f = _monic(F, poly._asc())
    n = hp.degree(f)
    if n % d != 0:
        raise ValueError(f"Polynomial degree {n} is not a multiple of {d}.")
    if n // d == 1:
        return [Poly._from_asc(f, field)]
    if rng is None:
        rng = random.Random(0xC0FFEE ^ int(poly))

    def split(f):
        n_f = hp.degree(f)
        if n_f == d:
            return [f]
        while True:
            h = hp.trim([rng.randrange(q) for _ in range(n_f)])  # degree < n_f
            if hp.degree(h) < 1:
                continue
            g = hp.gcd(F, f, h)
            if hp.degree(g) == 0:
                if q % 2 == 1:
                    # t = h^((q^d - 1)/2) - 1
                    t = hp.sub(F, hp.pow_mod(F, h, (q**d - 1) // 2, f), [1])
                else:
                    # even characteristic: the trace sum of h^(2^i), i < d log2(q)
                    t = [0]
                    cur = hp.mod(F, h, f)
                    for _ in range(d * (q.bit_length() - 1)):
                        t = hp.add(F, t, cur)
                        cur = hp.mod(F, hp.mul(F, cur, cur), f)
                g = hp.gcd(F, f, t)
            if 0 < hp.degree(g) < n_f:
                return split(g) + split(hp.divmod_(F, f, g)[0])

    return sorted((Poly._from_asc(fa, field) for fa in split(f)), key=int)


def factors(poly: Poly) -> Tuple[List[Poly], List[int]]:
    """The complete factorization into monic irreducibles with their
    multiplicities: square-free, then distinct-degree, then equal-degree."""
    if poly.degree < 1:
        raise ValueError("The polynomial must have degree >= 1.")
    field = poly.field
    F = _hf(field)
    lead = poly._ensure_terms()._coeffs[0]
    f = poly if lead == 1 else poly * Poly([F.reciprocal(lead)], field=field)

    all_factors: List[Poly] = []
    all_mults: List[int] = []
    for sf, mult in zip(*square_free_factors(f)):
        for dd, deg in zip(*distinct_degree_factors(sf)):
            for irr in equal_degree_factors(dd, deg):
                all_factors.append(irr)
                all_mults.append(mult)
    order = sorted(range(len(all_factors)), key=lambda k: int(all_factors[k]))
    return [all_factors[k] for k in order], [all_mults[k] for k in order]


def is_square_free(poly: Poly) -> bool:
    """f is square-free iff gcd(f, f') = 1, where a vanishing derivative
    (f a p-th power) means it is not."""
    if poly.degree == 0:
        return True
    F = _hf(poly.field)
    f = _monic(F, poly._asc())
    d = hp.derivative(F, f)
    if hp.trim(d) == [0]:
        return False
    return hp.gcd(F, f, d) == [1]
