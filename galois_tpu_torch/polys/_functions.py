"""Polynomial gcd, egcd, lcm, prod and crt.

Port of ``galois_tpu/polys/_functions.py``, unchanged in behaviour: exact
host arithmetic on ascending coefficient lists (``polys/_hostpoly.py``).
"""

from __future__ import annotations

from typing import Tuple

from . import _hostpoly as hp
from ._poly import Poly, _hf

__all__ = ["poly_gcd", "poly_egcd", "poly_lcm", "poly_prod", "poly_crt"]


def _common_field(*polys):
    field = polys[0].field
    for q in polys[1:]:
        if q.field._meta != field._meta:
            raise TypeError("Polynomials must be over the same field.")
    return field


def poly_gcd(a: Poly, b: Poly) -> Poly:
    """The monic greatest common divisor."""
    field = _common_field(a, b)
    return Poly._from_asc(hp.gcd(_hf(field), a._asc(), b._asc()), field)


def poly_egcd(a: Poly, b: Poly) -> Tuple[Poly, Poly, Poly]:
    """(d, s, t) with a s + b t = d, d monic."""
    field = _common_field(a, b)
    g, s, t = hp.egcd(_hf(field), a._asc(), b._asc())
    return Poly._from_asc(g, field), Poly._from_asc(s, field), Poly._from_asc(t, field)


def poly_lcm(*polys: Poly) -> Poly:
    """The monic least common multiple."""
    field = _common_field(*polys)
    F = _hf(field)
    lcm = [1]
    for p in polys:
        g = hp.gcd(F, lcm, p._asc())
        lcm = hp.divmod_(F, hp.mul(F, lcm, p._asc()), g)[0]
    if lcm != [0]:
        lcm = hp.scalar_mul(F, lcm, F.reciprocal(lcm[-1]))
    return Poly._from_asc(lcm, field)


def poly_prod(*polys: Poly) -> Poly:
    field = _common_field(*polys)
    F = _hf(field)
    out = [1]
    for p in polys:
        out = hp.mul(F, out, p._asc())
    return Poly._from_asc(out, field)


def poly_crt(remainders, moduli) -> Poly:
    """The Chinese remainder theorem for polynomials: the unique solution
    modulo the moduli's product; raises ``ValueError`` where none exists."""
    field = _common_field(*remainders, *moduli)
    r0, m0 = remainders[0], moduli[0]
    for r1, m1 in zip(remainders[1:], moduli[1:]):
        g, s, _ = poly_egcd(m0, m1)
        if (r1 - r0) % g != Poly.Zero(field):
            raise ValueError("The solution to the CRT system does not exist.")
        lhs = ((r1 - r0) // g) * s % (m1 // g)
        r0 = r0 + lhs * m0
        m0 = m0 * (m1 // g)
        r0 = r0 % m0
    return r0
