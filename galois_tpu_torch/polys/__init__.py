"""Polynomials over Galois fields: the core of ``Poly`` (construction,
host arithmetic, batched evaluation, roots), the irreducibility and
primitivity tests and searches, Conway and Lagrange polynomials, and the
host representation conversions."""

from ._conway import conway_poly, is_conway, is_conway_consistent
from ._irreducible import irreducible_poly, irreducible_polys, is_irreducible
from ._lagrange import lagrange_poly
from ._poly import Poly
from ._primitive import is_primitive, matlab_primitive_poly, primitive_poly, primitive_polys

__all__ = [
    "Poly",
    "conway_poly",
    "is_conway",
    "is_conway_consistent",
    "lagrange_poly",
    "irreducible_poly",
    "irreducible_polys",
    "is_irreducible",
    "is_primitive",
    "matlab_primitive_poly",
    "primitive_poly",
    "primitive_polys",
]
