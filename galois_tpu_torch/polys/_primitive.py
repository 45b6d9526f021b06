"""Primitive polynomial tests and searches.

Port of ``galois_tpu/polys/_primitive.py`` (reference:
src/galois/_polys/_primitive.py:28-433), host code on Python ints."""

from __future__ import annotations

from typing import Iterator, Union

from ..nt import factors as int_factors
from . import _binary as bp
from . import _hostpoly as hp
from ._irreducible import is_irreducible
from ._poly import Poly, _hf
from ._search import (
    deterministic_search,
    deterministic_search_fixed_terms,
    minimum_terms,
    random_search,
    random_search_fixed_terms,
)

__all__ = ["is_primitive", "primitive_poly", "primitive_polys", "matlab_primitive_poly"]


def is_primitive(poly: Poly) -> bool:
    """f over GF(q) is primitive iff it is irreducible and f does not divide
    x^((q^m-1)/pi) - 1 for any prime pi | q^m - 1 (HAC Algorithm 4.77;
    reference: src/galois/_polys/_primitive.py:28-104). Monicity is NOT
    required — divisibility is up to units."""
    field = poly.field
    q = field.order
    m = poly.degree
    if m == 0:
        return False
    if q == 2:
        # Packed-int path (GF(2)[x] kernels in polys/_binary.py).
        f2 = int(poly)
        if m == 1:
            return f2 == 0b11  # x + 1
        if f2 & 1 == 0:
            return False  # zero constant term
        if not is_irreducible(poly):
            return False
        n = 2**m - 1
        primes, _ = int_factors(n)
        for pi in primes:
            # f | x^(n/pi) - 1  <=>  x^(n/pi) mod f == 1
            if bp.pow_mod(2, n // pi, f2) == 1:
                return False
        return True
    if poly._asc()[0] == 0:
        return False  # zero constant term
    if not is_irreducible(poly):
        return False

    F = _hf(field)
    # normalize monic (divisibility is unaffected)
    f = poly._asc()
    if f[-1] != 1:
        f = hp.scalar_mul(F, f, F.reciprocal(f[-1]))
    n = q**m - 1
    primes, _ = int_factors(n)
    for pi in primes:
        # f | x^(n/pi) - 1  <=>  x^(n/pi) mod f == 1
        if hp.pow_mod(F, [0, 1], n // pi, f) == [1]:
            return False
    return True


def primitive_poly(
    order: int,
    degree: int,
    terms: Union[int, str, None] = None,
    method: str = "min",
) -> Poly:
    """Find a monic primitive polynomial
    (reference: src/galois/_polys/_primitive.py:108-238)."""
    from ..fields import GF

    order, degree = int(order), int(degree)
    if method not in ("min", "max", "random"):
        raise ValueError(f"Argument 'method' must be in ['min', 'max', 'random'], not {method!r}.")
    field = GF(order)
    test = is_primitive
    if terms == "min":
        t = minimum_terms(order, degree, test)
        poly = deterministic_search_fixed_terms(field, degree, t, test, reverse=(method == "max"))
    elif isinstance(terms, int):
        if method == "random":
            poly = random_search_fixed_terms(field, degree, terms, test)
        else:
            poly = deterministic_search_fixed_terms(field, degree, terms, test, reverse=(method == "max"))
    elif method == "random":
        poly = random_search(field, degree, test)
    else:
        poly = deterministic_search(field, degree, test, reverse=(method == "max"))
    if poly is None:
        raise RuntimeError(
            f"No monic primitive polynomial of degree {degree} over GF({order}) "
            f"with {terms} terms exists."
        )
    return poly


def primitive_polys(
    order: int,
    degree: int,
    terms: Union[int, str, None] = None,
    reverse: bool = False,
) -> Iterator[Poly]:
    """Iterate over all monic primitive polynomials of the given degree over
    GF(order), optionally restricted to `terms` nonzero terms
    (reference: src/galois/_polys/_primitive.py:157-256)."""
    from ..fields import GF

    order, degree = int(order), int(degree)
    field = GF(order)
    if terms == "min":
        terms = minimum_terms(order, degree, is_primitive)
    start = order**degree
    stop = 2 * order**degree
    rng = range(stop - 1, start - 1, -1) if reverse else range(start, stop)
    for i in rng:
        poly = Poly.Int(i, field=field)
        if terms is not None and len(poly.nonzero_degrees) != terms:
            continue
        if is_primitive(poly):
            yield poly


def matlab_primitive_poly(characteristic: int, degree: int) -> Poly:
    """Matlab's default primitive polynomial: the lexicographically first,
    with three hard-coded exceptions (degrees 7, 14, 16 over GF(2)) where
    Matlab differs (reference: src/galois/_polys/_primitive.py:358-433)."""
    characteristic, degree = int(characteristic), int(degree)
    if characteristic == 2 and degree == 7:
        return Poly.Degrees([7, 3, 0])
    if characteristic == 2 and degree == 14:
        return Poly.Degrees([14, 10, 6, 1, 0])
    if characteristic == 2 and degree == 16:
        return Poly.Degrees([16, 12, 3, 1, 0])
    return primitive_poly(characteristic, degree)
