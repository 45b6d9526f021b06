"""The GF() class factory.

Port of ``galois_tpu/fields/_factory.py``: manufactures FieldArray subclasses
for GF(p) and GF(2^m), flyweight-cached per (p, m, irreducible poly,
primitive element). GF(2^m) uses the Conway polynomial and x as the
primitive element; a user-given irreducible polynomial needs the port of
``polys/_hostpoly.py`` and is still to come.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..nt import factors, is_prime, is_primitive_root, primitive_root
from ._array import FieldArray, FieldArrayMeta
from ._meta import FieldMeta

__all__ = ["GF", "Field"]

_FIELD_CACHE = {}


@functools.lru_cache(maxsize=None)
def _factor_prime_power(order: int):
    primes, exponents = factors(order)
    if len(primes) != 1:
        raise ValueError(
            f"Argument 'order' must be a prime power, not {order} = "
            + " * ".join(f"{p}^{e}" for p, e in zip(primes, exponents))
            + "."
        )
    return primes[0], exponents[0]


def GF(
    order: Optional[int] = None,
    degree: Optional[int] = None,
    *,
    irreducible_poly=None,
    primitive_element=None,
    verify: bool = True,
    compile: Optional[str] = None,
    repr: Optional[str] = None,
):
    """Create a FieldArray subclass for GF(p^m).

    Call as ``GF(order)`` or ``GF(characteristic, degree)``. Arrays of the
    returned class take a ``device=`` argument; see ``FieldArray``.
    """
    if degree is not None:
        characteristic = int(order)
        degree = int(degree)
        if verify and not is_prime(characteristic):
            raise ValueError(f"Argument 'characteristic' must be prime, not {characteristic}.")
        if degree < 1:
            raise ValueError(f"Argument 'degree' must be >= 1, not {degree}.")
        p, m = characteristic, degree
    else:
        p, m = _factor_prime_power(int(order))

    if compile not in (None, "auto", "jit-calculate"):
        raise NotImplementedError(
            f"Compile mode {compile!r} is not ported yet; the port runs 'jit-calculate' "
            "(ROADMAP.md, queue 1 item 6)."
        )
    if repr not in (None, "int"):
        raise NotImplementedError(f"Element repr {repr!r} is not ported yet; the port prints ints.")

    if m == 1:
        return _GF_prime(p, alpha=primitive_element, verify=verify)
    return _GF_extension(p, m, irreducible_poly=irreducible_poly, alpha=primitive_element)


def Field(*args, **kwargs):
    """Deprecated alias of GF()."""
    return GF(*args, **kwargs)


def _GF_prime(p: int, alpha=None, verify: bool = True):
    """GF(p): default alpha = smallest primitive root; irreducible poly is
    f(x) = x - alpha, integer repr 2p - alpha."""
    if alpha is None:
        alpha = 1 if p == 2 else primitive_root(p)
    else:
        if not isinstance(alpha, (int, np.integer)):
            raise TypeError(f"Argument 'primitive_element' must be an int, not {type(alpha)}.")
        alpha = int(alpha) % p
        if verify and p > 2 and not is_primitive_root(alpha, p):
            raise ValueError(
                f"Argument 'primitive_element' must be a primitive root mod {p}, not {alpha}."
            )
    f_int = 2 * p - alpha if alpha > 0 else p
    return _make_class(p, 1, f_int, alpha)


def _GF_extension(p: int, m: int, irreducible_poly=None, alpha=None):
    """GF(2^m) with the Conway polynomial, which is primitive, so x generates
    the field."""
    if p != 2 or irreducible_poly is not None or alpha is not None:
        raise NotImplementedError(
            "The torch port builds GF(2^m) with its default Conway polynomial only; other "
            "extension fields and user-given polynomials or primitive elements wait for the "
            "Poly layer (ROADMAP.md, queue 1 item 4)."
        )
    from .._databases import ConwayPolyDatabase

    degrees, coeffs = ConwayPolyDatabase().fetch(p, m)
    f_int = sum(c * p**d for d, c in zip(degrees, coeffs))
    return _make_class(p, m, f_int, p)


def _make_class(p: int, m: int, f_int: int, alpha: int):
    key = (p, m, f_int, alpha)
    if key in _FIELD_CACHE:
        return _FIELD_CACHE[key]

    meta = FieldMeta(p, m, f_int, alpha)
    name = f"GF_{p}" if m == 1 else f"GF_{p}_{m}"
    cls = FieldArrayMeta(name, (FieldArray,), {"_meta": meta, "_mode": meta.default_ufunc_mode})
    cls.__doc__ = f"A FieldArray subclass over {meta.name}."
    _FIELD_CACHE[key] = cls
    return cls
