"""The functions that take either ints or Polys.

Port of ``galois_tpu/_polymorphic.py``: ints go to the number-theory layer
(``nt/``), Polys to the polynomial layer (``polys/_functions.py`` and
``polys/_factor.py``). These shadow the int-only ``nt`` versions at the
package's top level, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import nt as _nt
from .polys._factor import factors as _poly_factors
from .polys._factor import is_square_free as _poly_is_square_free
from .polys._functions import poly_crt, poly_egcd, poly_gcd, poly_lcm, poly_prod
from .polys._poly import Poly, _hf

__all__ = ["gcd", "egcd", "lcm", "prod", "are_coprime", "crt", "factors", "is_square_free"]


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer))


def gcd(a, b):
    """Greatest common divisor of two ints or two Polys."""
    if _is_int(a) and _is_int(b):
        return _nt.gcd(int(a), int(b))
    if isinstance(a, Poly) and isinstance(b, Poly):
        return poly_gcd(a, b)
    raise TypeError(f"Arguments must both be ints or both be Polys, not {type(a)} and {type(b)}.")


def egcd(a, b):
    """The extended Euclidean algorithm: (d, s, t) with a s + b t = d."""
    if _is_int(a) and _is_int(b):
        return _nt.egcd(int(a), int(b))
    if isinstance(a, Poly) and isinstance(b, Poly):
        return poly_egcd(a, b)
    raise TypeError(f"Arguments must both be ints or both be Polys, not {type(a)} and {type(b)}.")


def lcm(*values):
    """Least common multiple of ints or Polys."""
    if all(_is_int(v) for v in values):
        return _nt.lcm(*[int(v) for v in values])
    if all(isinstance(v, Poly) for v in values):
        return poly_lcm(*values)
    raise TypeError("Arguments must all be ints or all be Polys.")


def prod(*values):
    """Product of ints or Polys."""
    if all(_is_int(v) for v in values):
        return _nt.prod(*[int(v) for v in values])
    if all(isinstance(v, Poly) for v in values):
        return poly_prod(*values)
    raise TypeError("Arguments must all be ints or all be Polys.")


def are_coprime(*values) -> bool:
    """Whether the arguments are pairwise coprime: their lcm equals their
    product (for Polys, up to the product's leading coefficient)."""
    if all(_is_int(v) for v in values):
        ints = [int(v) for v in values]
        return _nt.lcm(*ints) == _nt.prod(*ints)
    if all(isinstance(v, Poly) for v in values):
        l, p = poly_lcm(*values), poly_prod(*values)
        if p.is_zero:
            return l.is_zero
        lead = p._ensure_terms()._coeffs[0]
        if lead != 1:
            p = p * Poly([_hf(p.field).reciprocal(lead)], field=p.field)
        return l == p
    raise TypeError("Arguments must all be ints or all be Polys.")


def crt(remainders: Sequence, moduli: Sequence):
    """The Chinese remainder theorem over ints or Polys: the unique solution
    modulo the moduli's product."""
    if all(_is_int(v) for v in list(remainders) + list(moduli)):
        return _nt.crt([int(r) for r in remainders], [int(m) for m in moduli])
    if all(isinstance(v, Poly) for v in list(remainders) + list(moduli)):
        return poly_crt(list(remainders), list(moduli))
    raise TypeError("Arguments must all be ints or all be Polys.")


def factors(value):
    """Factor an int into primes or a Poly into monic irreducibles, with
    multiplicities."""
    if _is_int(value):
        return _nt.factors(int(value))
    if isinstance(value, Poly):
        return _poly_factors(value)
    raise TypeError(f"Argument must be an int or Poly, not {type(value)}.")


def is_square_free(value) -> bool:
    """Whether an int or a Poly has no repeated factor."""
    if _is_int(value):
        return _nt.is_square_free(int(value))
    if isinstance(value, Poly):
        return _poly_is_square_free(value)
    raise TypeError(f"Argument must be an int or Poly, not {type(value)}.")
