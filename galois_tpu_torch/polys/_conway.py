"""Conway polynomials.

Port of ``galois_tpu/polys/_conway.py``: the lookup reads the port's own
packed Luebeck table (``galois_tpu_torch/_databases``); ``search=True``
runs the defining search in Conway's lexicographic order. The tests are
host polynomial arithmetic.
"""

from __future__ import annotations

import functools

from ..nt import divisors
from . import _hostpoly as hp
from ._poly import Poly, _hf
from ._primitive import is_primitive

__all__ = ["conway_poly", "is_conway", "is_conway_consistent"]


@functools.lru_cache(maxsize=None)
def conway_poly(characteristic: int, degree: int, search: bool = False) -> Poly:
    """The Conway polynomial C_{p,m} over GF(p)."""
    from .._databases import ConwayPolyDatabase
    from ..fields import GF
    from ..nt import is_prime

    p, m = int(characteristic), int(degree)
    if not is_prime(p):
        raise ValueError(f"Argument 'characteristic' must be prime, not {p}.")
    if m < 1:
        raise ValueError(f"Argument 'degree' must be at least 1, not {m}.")
    try:
        degs, coeffs = ConwayPolyDatabase().fetch(p, m)
        return Poly.Degrees(degs, coeffs, field=GF(p))
    except LookupError:
        if not search:
            raise LookupError(
                f"The Conway polynomial C_{{{p},{m}}} is not in the database. "
                "Pass search=True to run the (exponential-time) defining search."
            ) from None
    return _conway_search(p, m)


def _conway_lex_key(poly: Poly):
    """Conway's order: the words w_i = (-1)^(m-i) a_i mod p for i = m-1 .. 0,
    compared lexicographically."""
    p, m = poly.field.characteristic, poly.degree
    asc = poly._asc()
    word = []
    for i in range(m - 1, -1, -1):
        a = asc[i] if i < len(asc) else 0
        word.append(a if (m - i) % 2 == 0 else (-a) % p)
    return tuple(word)


def _conway_search(p: int, m: int) -> Poly:
    from ..fields import GF

    field = GF(p)
    candidates = sorted((Poly.Int(i, field=field) for i in range(p**m, 2 * p**m)), key=_conway_lex_key)
    for f in candidates:
        if is_conway_consistent(f):
            return f
    raise RuntimeError(f"No Conway polynomial found for GF({p}^{m}).")


def is_conway(poly: Poly, search: bool = False) -> bool:
    """Whether ``poly`` is the Conway polynomial C_{p,m}."""
    if poly.field.degree != 1:
        raise ValueError("Conway polynomials are defined over prime fields GF(p).")
    return poly == conway_poly(poly.field.characteristic, poly.degree, search=search)


def is_conway_consistent(poly: Poly, search: bool = False) -> bool:
    """Whether ``poly`` is monic, primitive, and compatible with the Conway
    polynomials of every proper divisor degree d of m:
    C_{p,d}(x^((p^m - 1)/(p^d - 1))) = 0 mod f."""
    field = poly.field
    p = field.characteristic
    if field.degree != 1:
        raise ValueError("Conway polynomials are defined over prime fields GF(p).")
    m = poly.degree
    if not poly.is_monic or not is_primitive(poly):
        return False
    F = _hf(field)
    f = poly._asc()
    for d in divisors(m):
        if d == m:
            continue
        g = conway_poly(p, d, search=search)
        y = hp.pow_mod(F, [0, 1], (p**m - 1) // (p**d - 1), f)  # g is evaluated at y = x^e mod f
        acc = [0]
        for deg, coeff in zip(g._ensure_terms()._degrees, g._coeffs):
            acc = hp.add(F, acc, hp.scalar_mul(F, hp.pow_mod(F, y, deg, f), coeff))
        if hp.trim(hp.mod(F, acc, f)) != [0]:
            return False
    return True
