"""Primitive elements of GF(q^m) = GF(q)[x]/f, as polynomials over GF(q).

Port of ``galois_tpu/fields/_primitive_element.py``: exact host searches on
Python ints (``HostField``). Unlike the JAX package, the arguments are
checked as the reference checks them: an ``irreducible_poly`` that is not a
``Poly``, or an element that is not an int, a ``Poly`` or a polynomial
string in x, raises TypeError.
"""

from __future__ import annotations

import random as _random

import numpy as np

from ..nt import totatives
from ..polys._poly import Poly
from ._hostfield import HostField

__all__ = ["is_primitive_element", "primitive_element", "primitive_elements"]


def _field_from_poly(irreducible_poly: Poly):
    """GF(p^m) = GF(p)[x]/f for a degree-m irreducible f over GF(p)."""
    from ._factory import GF

    if not isinstance(irreducible_poly, Poly):
        raise TypeError(f"Argument 'irreducible_poly' must be a Poly, not {type(irreducible_poly).__name__}.")
    base = irreducible_poly.field
    if not base.is_prime_field:
        raise ValueError("Primitive-element search requires a prime base field GF(p).")
    p, m = base.characteristic, irreducible_poly.degree
    return GF(p**m, irreducible_poly=int(irreducible_poly))


def _element_to_int(element, field) -> int:
    """The int repr of an int, a Poly or a polynomial string in x."""
    from ..polys._conversions import str_to_integer

    if isinstance(element, Poly):
        return int(element)
    if isinstance(element, str) and all(c == "x" for c in element if c.isalpha()):
        return str_to_integer(element, field.characteristic)
    if isinstance(element, (int, np.integer)):
        return int(element)
    raise TypeError(f"Argument 'element' must be an int, a Poly or a polynomial string in x, not {element!r}.")


def is_primitive_element(element, irreducible_poly: Poly) -> bool:
    """Whether ``element`` generates the multiplicative group of
    GF(q^m) = GF(q)[x]/(irreducible_poly)."""
    field = _field_from_poly(irreducible_poly)
    e = _element_to_int(element, field)
    if not 0 < e < field.order:
        return False
    return HostField(field._meta).is_primitive_element(e)


def primitive_element(irreducible_poly: Poly, method: str = "min") -> Poly:
    """A primitive element of GF(q^m) = GF(q)[x]/f: the smallest, the
    largest, or a random one (``method``)."""
    if method not in ("min", "max", "random"):
        raise ValueError(f"Argument 'method' must be in ['min', 'max', 'random'], not {method!r}.")
    field = _field_from_poly(irreducible_poly)
    hf = HostField(field._meta)
    q = field.order
    if method == "random":
        r = _random.Random()
        while True:
            e = r.randrange(1, q)
            if hf.is_primitive_element(e):
                return Poly.Int(e, field=field.prime_subfield)
    for e in range(1, q) if method == "min" else range(q - 1, 0, -1):
        if hf.is_primitive_element(e):
            return Poly.Int(e, field=field.prime_subfield)
    raise RuntimeError("No primitive element found; is the polynomial irreducible?")


def primitive_elements(irreducible_poly: Poly) -> list:
    """All primitive elements, ascending: the powers of one primitive element
    with exponents coprime to q^m - 1."""
    field = _field_from_poly(irreducible_poly)
    hf = HostField(field._meta)
    alpha = int(primitive_element(irreducible_poly))
    elems = sorted(hf.power(alpha, k) for k in totatives(field.order - 1))
    return [Poly.Int(e, field=field.prime_subfield) for e in elems]
