"""Irreducible polynomial tests and searches.

Port of ``galois_tpu/polys/_irreducible.py`` (reference:
src/galois/_polys/_irreducible.py:29-373), host code on Python ints; the
minimal-term table is the port's own copy (``_databases``)."""

from __future__ import annotations

from typing import Iterator, Union

from ..nt import factors as int_factors
from . import _binary as bp
from . import _hostpoly as hp
from ._poly import Poly, _hf
from ._search import (
    deterministic_search,
    deterministic_search_fixed_terms,
    minimum_terms,
    random_search,
    random_search_fixed_terms,
)

__all__ = ["is_irreducible", "irreducible_poly", "irreducible_polys"]


def is_irreducible(poly: Poly) -> bool:
    """Rabin's irreducibility test over any base field GF(q)
    (reference algorithm: src/galois/_polys/_irreducible.py:29-124)."""
    field = poly.field
    q = field.order
    m = poly.degree
    if m == 0:
        return False
    if m == 1:
        return True

    if q == 2:
        # Packed-int Rabin test: ~degree big-int squarings instead of
        # coefficient-list host loops (GF(2)[x] kernels in polys/_binary.py).
        f2 = int(poly)
        if f2 & 1 == 0:
            return False  # x | f
        if f2.bit_count() % 2 == 0:
            return False  # f(1) = 0 over GF(2)
        x2 = 2
        h = x2
        for _ in range(m):
            h = bp.mod(bp.square(h), f2)
        if h != x2:
            return False
        primes, _ = int_factors(m)
        for pi in primes:
            h = x2
            for _ in range(m // pi):
                h = bp.mod(bp.square(h), f2)
            if bp.gcd(f2, h ^ x2) != 1:
                return False
        return True

    F = _hf(field)
    f = poly._asc()
    if f[0] == 0:
        return False  # x | f

    # normalize monic
    f = hp.scalar_mul(F, f, F.reciprocal(f[-1]))
    x = [0, 1]
    # x^(q^m) mod f == x
    h = x
    for _ in range(m):
        h = hp.pow_mod(F, h, q, f)
    if hp.trim(hp.sub(F, h, x)) != [0]:
        return False
    primes, _ = int_factors(m)
    for pi in primes:
        h = x
        for _ in range(m // pi):
            h = hp.pow_mod(F, h, q, f)
        g = hp.gcd(F, f, hp.sub(F, h, x))
        if g != [1]:
            return False
    return True


def irreducible_poly(
    order: int,
    degree: int,
    terms: Union[int, str, None] = None,
    method: str = "min",
) -> Poly:
    """Find a monic irreducible polynomial of the given degree over GF(order)
    (reference: src/galois/_polys/_irreducible.py:128-259)."""
    from ..fields import GF

    order, degree = int(order), int(degree)
    if method not in ("min", "max", "random"):
        raise ValueError(f"Argument 'method' must be in ['min', 'max', 'random'], not {method!r}.")
    if degree < 1:
        raise ValueError(f"Argument 'degree' must be at least 1, not {degree}.")
    if isinstance(terms, int) and not 1 <= terms <= degree + 1:
        raise ValueError(f"Argument 'terms' must be at least 1 and at most {degree + 1}, not {terms}.")
    if isinstance(terms, str) and terms != "min":
        raise ValueError(f"Argument 'terms' must be 'min', not {terms!r}.")

    field = GF(order)

    # Database fast path (reference: _irreducible.py:231)
    if method == "min" and terms == "min":
        try:
            from .._databases import IrreduciblePolyDatabase

            primes, exps = int_factors(order)
            if len(primes) == 1 and exps[0] == 1:
                degs, coeffs = IrreduciblePolyDatabase().fetch(order, degree)
                return Poly.Degrees(degs, coeffs, field=field)
        except LookupError:
            pass

    test = is_irreducible
    if terms == "min":
        t = minimum_terms(order, degree, test)
        poly = deterministic_search_fixed_terms(field, degree, t, test, reverse=(method == "max"))
    elif isinstance(terms, int):
        poly = deterministic_search_fixed_terms(field, degree, terms, test, reverse=(method == "max"))
        if method == "random":
            poly = random_search_fixed_terms(field, degree, terms, test)
    elif method == "random":
        poly = random_search(field, degree, test)
    else:
        poly = deterministic_search(field, degree, test, reverse=(method == "max"))
    if poly is None:
        raise RuntimeError(
            f"No monic irreducible polynomial of degree {degree} over GF({order}) "
            f"with {terms} terms exists."
        )
    return poly


def irreducible_polys(
    order: int,
    degree: int,
    terms: Union[int, str, None] = None,
    reverse: bool = False,
) -> Iterator[Poly]:
    """Iterate over all monic irreducible polynomials
    (reference: src/galois/_polys/_irreducible.py:260-373)."""
    from ..fields import GF

    order, degree = int(order), int(degree)
    field = GF(order)
    if terms == "min":
        terms = minimum_terms(order, degree, is_irreducible)

    start = order**degree
    stop = 2 * order**degree
    rng = range(stop - 1, start - 1, -1) if reverse else range(start, stop)
    for i in rng:
        poly = Poly.Int(i, field=field)
        if terms is not None and len(poly.nonzero_degrees) != terms:
            continue
        if is_irreducible(poly):
            yield poly
