"""Polynomials over Galois fields: the core of ``Poly`` (construction,
host arithmetic, batched evaluation), the irreducibility and primitivity
tests and searches, and the host representation conversions."""

from ._irreducible import irreducible_poly, irreducible_polys, is_irreducible
from ._poly import Poly
from ._primitive import is_primitive, matlab_primitive_poly, primitive_poly, primitive_polys

__all__ = [
    "Poly",
    "irreducible_poly",
    "irreducible_polys",
    "is_irreducible",
    "is_primitive",
    "matlab_primitive_poly",
    "primitive_poly",
    "primitive_polys",
]
