"""Deterministic and random polynomial search engines.

Port of ``galois_tpu/polys/_search.py`` (reference:
src/galois/_polys/_search.py:20-171), host code on Python ints.

Searches iterate candidates by integer representation (lexicographic order on
descending coefficients), optionally restricted to a fixed number of nonzero
terms."""

from __future__ import annotations

import itertools
import random
from typing import Callable, Optional

from ._poly import Poly

__all__ = [
    "deterministic_search",
    "deterministic_search_fixed_terms",
    "random_search",
    "random_search_fixed_terms",
    "minimum_terms",
]


def deterministic_search(field, degree: int, test: Callable, reverse: bool = False) -> Optional[Poly]:
    order = field.order
    start, stop = order**degree, 2 * order**degree
    rng = range(stop - 1, start - 1, -1) if reverse else range(start, stop)
    for i in rng:
        poly = Poly.Int(i, field=field)
        if test(poly):
            return poly
    return None


def _fixed_term_candidates(field, degree: int, terms: int, reverse: bool = False):
    """Monic degree-`degree` polys with exactly `terms` nonzero terms, in
    integer-representation order."""
    order = field.order
    if terms == 1:
        yield Poly.Degrees([degree], [1], field=field)
        return
    # x^degree + (terms-1 lower nonzero terms); iterate over degree choices
    # and coefficient assignments in lexicographic (integer) order.
    lower_degrees = list(range(degree - 1, -1, -1))
    coeff_range = list(range(1, order))

    combos = itertools.combinations(lower_degrees, terms - 1)
    polys = []
    for degs in combos:
        for coeffs in itertools.product(coeff_range, repeat=terms - 1):
            polys.append(Poly.Degrees((degree,) + degs, (1,) + coeffs, field=field))
    polys.sort(key=int, reverse=reverse)
    yield from polys


def deterministic_search_fixed_terms(
    field, degree: int, terms: int, test: Callable, reverse: bool = False
) -> Optional[Poly]:
    for poly in _fixed_term_candidates(field, degree, terms, reverse=reverse):
        if test(poly):
            return poly
    return None


def random_search(field, degree: int, test: Callable, seed=None) -> Poly:
    rng = random.Random(seed)
    order = field.order
    while True:
        i = rng.randrange(order**degree, 2 * order**degree)
        poly = Poly.Int(i, field=field)
        if test(poly):
            return poly


def random_search_fixed_terms(field, degree: int, terms: int, test: Callable, seed=None) -> Poly:
    rng = random.Random(seed)
    order = field.order
    if terms == 1:
        poly = Poly.Degrees([degree], [1], field=field)
        return poly if test(poly) else None
    while True:
        degs = rng.sample(range(degree - 1, -1, -1), terms - 1)
        coeffs = [rng.randrange(1, order) for _ in degs]
        poly = Poly.Degrees([degree] + degs, [1] + coeffs, field=field)
        if test(poly):
            return poly


def minimum_terms(order: int, degree: int, test: Callable) -> int:
    """Smallest number of nonzero terms for which a qualifying polynomial
    exists (reference: src/galois/_polys/_search.py:144-171)."""
    from ..fields import GF

    field = GF(order)
    if order == 2:
        # Over GF(2), an even number of terms gives f(1) = 0; candidates are
        # odd term counts only.
        counts = range(1, degree + 2, 2) if degree >= 1 else [1]
    else:
        counts = range(1, degree + 2)
    for t in counts:
        if deterministic_search_fixed_terms(field, degree, t, test) is not None:
            return t
    raise RuntimeError(
        f"No polynomial of degree {degree} over GF({order}) passes the test."
    )
