"""The GF() class factory.

Port of ``galois_tpu/fields/_factory.py``: manufactures FieldArray subclasses
for GF(p^m) with int storage, flyweight-cached per (p, m, irreducible poly,
primitive element). Extension fields default to the Conway polynomial and x
as the primitive element; a user-given irreducible polynomial passes Rabin's
irreducibility test, and without a given primitive element the smallest one
is searched.
"""

from __future__ import annotations

import copyreg
import functools
import itertools
from typing import Optional

import numpy as np
import torch

from .._options import resolve_device
from ..nt import factors, is_prime, is_primitive_root, primitive_root
from ..polys._conversions import integer_to_poly, poly_to_integer, poly_to_str, str_to_integer
from ._array import FieldArray, FieldArrayMeta
from ._hostfield import HostField
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

    Call as ``GF(order)`` or ``GF(characteristic, degree)``. ``compile``
    sets the class's ufunc mode (``"auto"``, ``"jit-calculate"``,
    ``"python-calculate"`` or, for orders <= 2^20, ``"jit-lookup"``) and
    ``repr`` its element repr (``"int"``, ``"poly"`` or ``"power"``); both
    are state of the cached class. Arrays of the returned class take a
    ``device=`` argument; see ``FieldArray``.
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

    if m == 1:
        cls = _GF_prime(p, alpha=primitive_element, verify=verify)
    else:
        cls = _GF_extension(
            p, m, irreducible_poly=irreducible_poly, alpha=primitive_element, verify=verify
        )
    if compile is not None:
        cls.compile(compile)
    if repr is not None:
        cls.repr(repr)
    return cls


def Field(*args, **kwargs):
    """Deprecated alias of GF()."""
    return GF(*args, **kwargs)


def _poly_like_to_int(poly, p: int) -> int:
    """An irreducible-poly argument (int, str, Poly or coefficient sequence,
    descending degrees) -> its integer representation over GF(p)."""
    from ..polys._poly import Poly

    if isinstance(poly, (int, np.integer)):
        return int(poly)
    if isinstance(poly, str):
        return str_to_integer(poly, p)
    if isinstance(poly, Poly):
        return int(poly)
    if isinstance(poly, (list, tuple, np.ndarray)):
        return poly_to_integer([int(c) for c in poly], p)
    raise TypeError(f"Cannot interpret {type(poly)} as an irreducible polynomial.")


def _element_like_to_int(element, p: int) -> int:
    if isinstance(element, (int, np.integer)):
        return int(element)
    if isinstance(element, str):
        return str_to_integer(element, p)
    if isinstance(element, FieldArray):
        return int(element)
    raise TypeError(f"Cannot interpret {type(element)} as a field element.")


def _GF_prime(p: int, alpha=None, verify: bool = True):
    """GF(p): default alpha = smallest primitive root; irreducible poly is
    f(x) = x - alpha, integer repr 2p - alpha."""
    if alpha is None:
        alpha = 1 if p == 2 else primitive_root(p)
    else:
        alpha = _element_like_to_int(alpha, p) % p
        if verify and p > 2 and not is_primitive_root(alpha, p):
            raise ValueError(
                f"Argument 'primitive_element' must be a primitive root mod {p}, not {alpha}."
            )
    f_int = 2 * p - alpha if alpha > 0 else p
    return _make_class(p, 1, f_int, alpha)


def _GF_extension(p: int, m: int, irreducible_poly=None, alpha=None, verify: bool = True):
    """GF(p^m): the Conway polynomial (primitive, so x generates the field)
    unless the caller gives a polynomial, which is then checked for
    irreducibility; a given primitive element is checked for primitivity."""
    verify_poly = verify_element = verify
    if irreducible_poly is None:
        from .._databases import ConwayPolyDatabase

        degrees, coeffs = ConwayPolyDatabase().fetch(p, m)
        f_int = sum(c * p**d for d, c in zip(degrees, coeffs))
        verify_poly = False
        if alpha is None:
            alpha = p  # x
            verify_element = False
    else:
        f_int = _poly_like_to_int(irreducible_poly, p)

    if not p**m <= f_int < 2 * p**m:
        raise ValueError(f"The irreducible polynomial must be monic of degree {m} over GF({p}).")
    if verify_poly and not _is_irreducible_int(f_int, p, m):
        raise ValueError(
            f"Argument 'irreducible_poly' must be irreducible, "
            f"{poly_to_str(integer_to_poly(f_int, p))} is not."
        )

    if alpha is None:
        alpha = _smallest_primitive_element(p, m, f_int)
        verify_element = False
    else:
        alpha = _element_like_to_int(alpha, p)
    if verify_element and not HostField(FieldMeta(p, m, f_int, alpha)).is_primitive_element(alpha):
        raise ValueError(f"Argument 'primitive_element' must be primitive, {alpha} is not.")
    return _make_class(p, m, f_int, alpha)


def _is_irreducible_int(f_int: int, p: int, m: int) -> bool:
    """Rabin's irreducibility test on the integer poly representation:
    x^(p^m) = x mod f, and gcd(f, x^(p^(m/r)) - x) = 1 for each prime r | m."""
    from ..polys import _hostpoly as hp

    F = HostField(GF(p)._meta)
    f = integer_to_poly(f_int, p)[::-1]  # ascending
    if f[0] == 0:
        return False  # x divides f
    x = [0, 1]
    h = x
    for _ in range(m):
        h = hp.pow_mod(F, h, p, f)
    if hp.trim(hp.sub(F, h, x)) != [0]:
        return False
    for r in factors(m)[0]:
        h = x
        for _ in range(m // r):
            h = hp.pow_mod(F, h, p, f)
        if hp.gcd(F, f, hp.sub(F, h, x)) != [1]:
            return False
    return True


def _smallest_primitive_element(p: int, m: int, f_int: int) -> int:
    """The JAX package's search order: the non-constant elements p .. p^m - 1
    first, then the constants 2 .. p - 1."""
    hf = HostField(FieldMeta(p, m, f_int, p))  # alpha placeholder
    for a in itertools.chain(range(p, p**m), range(2, p)):
        if hf.is_primitive_element(a):
            return a
    raise RuntimeError("No primitive element found: is the polynomial irreducible?")


def _make_class(p: int, m: int, f_int: int, alpha: int):
    key = (p, m, f_int, alpha)
    if key in _FIELD_CACHE:
        return _FIELD_CACHE[key]

    meta = FieldMeta(p, m, f_int, alpha)
    name = f"GF_{p}" if m == 1 else f"GF_{p}_{m}"
    cls = FieldArrayMeta(name, (FieldArray,), {"_meta": meta, "_mode": meta.default_ufunc_mode, "_element_repr": "int"})
    cls.__doc__ = f"A FieldArray subclass over {meta.name}."
    _FIELD_CACHE[key] = cls
    return cls


# ----------------------------------------------------------------------
# Pickling: a field class is rebuilt from (p, m, f, alpha), with the ufunc
# mode and element repr it was pickled with, so that it unpickles as the
# cached class itself; an array carries its storage as a NumPy array.
# ----------------------------------------------------------------------

def _reconstruct_field_class(p, m, f_int, alpha, mode, element_repr):
    cls = _make_class(p, m, f_int, alpha)
    cls._mode = mode
    cls._element_repr = element_repr
    return cls


def _field_class_args(cls) -> tuple:
    meta = cls._meta
    return (meta.characteristic, meta.degree, meta.irreducible_poly_int, meta.primitive_element_int, cls._mode, cls._element_repr)


def _reduce_field_class(cls):
    if cls._meta is None:
        return cls.__qualname__  # Array and FieldArray pickle by name
    return _reconstruct_field_class, _field_class_args(cls)


copyreg.pickle(FieldArrayMeta, _reduce_field_class)


def _reconstruct_field_array(field_args, storage: np.ndarray, dtype):
    """An array from its pickle, on the default device at load time."""
    cls = _reconstruct_field_class(*field_args)
    return cls._view(torch.from_numpy(storage).to(resolve_device(None)), dtype)


def _reduce_field_array(x):
    # the storage tensor as it is (uint8, int64 or uint16 words): a 2^24-element
    # array pickles as one buffer, not as 2^24 Python ints
    return _reconstruct_field_array, (_field_class_args(type(x)), x._data.cpu().numpy(), x.dtype)


FieldArray.__reduce__ = _reduce_field_array
