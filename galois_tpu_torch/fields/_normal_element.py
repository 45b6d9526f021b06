"""Normal elements of GF(q^m) = GF(q)[x]/f, as polynomials over GF(q).

Port of ``galois_tpu/fields/_normal_element.py``. An element b is normal
over GF(q) when its Frobenius conjugates b, b^q, ..., b^(q^(m-1)) form a
GF(q)-basis: a rank test of their digit vectors, on the host. Arguments
are checked as in ``_primitive_element.py`` (TypeError, as the reference).
"""

from __future__ import annotations

import random as _random

from ..ops._linalg import _host_row_reduce
from ..polys._poly import Poly
from ._hostfield import get_host_field
from ._primitive_element import _element_to_int, _field_from_poly

__all__ = ["is_normal_element", "normal_element", "normal_elements"]


def _conjugate_matrix_rank(field, e: int) -> int:
    """Rank over GF(p) of the digit vectors of e, e^p, ..., e^(p^(m-1))."""
    meta = field._meta
    hf = get_host_field(meta)
    p, m = meta.characteristic, meta.degree
    A, cur = [], e
    for _ in range(m):
        A.append([int(v) for v in meta.int_to_digits(cur)])
        cur = hf.power(cur, p)
    return _host_row_reduce(field.prime_subfield, A, m)[1]


def is_normal_element(element, irreducible_poly: Poly) -> bool:
    """Whether ``element`` is normal in GF(q^m) = GF(q)[x]/(irreducible_poly)."""
    field = _field_from_poly(irreducible_poly)
    e = _element_to_int(element, field)
    if not 0 < e < field.order:
        return False
    return _conjugate_matrix_rank(field, e) == irreducible_poly.degree


def normal_element(irreducible_poly: Poly, method: str = "min") -> Poly:
    """A normal element of GF(q^m) = GF(q)[x]/f: the smallest, the largest,
    or a random one (``method``)."""
    if method not in ("min", "max", "random"):
        raise ValueError(f"Argument 'method' must be in ['min', 'max', 'random'], not {method!r}.")
    if not isinstance(irreducible_poly, Poly):
        raise TypeError(f"Argument 'irreducible_poly' must be a Poly, not {type(irreducible_poly).__name__}.")
    if irreducible_poly.degree < 1 or not irreducible_poly.is_irreducible():
        raise ValueError("Argument 'irreducible_poly' must be irreducible with degree >= 1.")
    field = _field_from_poly(irreducible_poly)
    m, q, sub = irreducible_poly.degree, field.order, field.prime_subfield
    if method == "random":
        r = _random.Random()
        while True:
            e = r.randrange(1, q)
            if _conjugate_matrix_rank(field, e) == m:
                return Poly.Int(e, field=sub)
    for e in range(1, q) if method == "min" else range(q - 1, 0, -1):
        if _conjugate_matrix_rank(field, e) == m:
            return Poly.Int(e, field=sub)
    raise RuntimeError("No normal element found.")


def normal_elements(irreducible_poly: Poly) -> list:
    """All normal elements, ascending."""
    field = _field_from_poly(irreducible_poly)
    m, sub = irreducible_poly.degree, field.prime_subfield
    return [Poly.Int(e, field=sub) for e in range(1, field.order) if _conjugate_matrix_rank(field, e) == m]
