"""Roots of polynomials over GF(p^m).

Port of ``galois_tpu/polys/_roots.py``, with its two routes:

- orders <= 2^20 and degree < 10000: the Chien scan, ``ops/_poly_eval.py``'s
  batched Horner over every element of the field (``field.elements``) on
  the default device, then one copy of the zero mask to the host;
- larger fields: the linear factors on the host, g = gcd(f, x^q - x) from
  x^q mod f, split by ``equal_degree_factors``.

Multiplicities come by repeated division by (x - r).
"""

from __future__ import annotations

import numpy as np

from ..fields._meta import LOOKUP_TABLE_MAX_ORDER
from . import _hostpoly as hp
from ._poly import Poly, _hf

__all__ = ["poly_roots"]


def poly_roots(poly: Poly, multiplicity: bool = False):
    field = poly.field
    if poly.degree == 0:
        roots = field([])
        return (roots, np.array([], dtype=np.int64)) if multiplicity else roots
    if field.order <= LOOKUP_TABLE_MAX_ORDER and poly.degree < 10_000:
        roots_int = _chien_roots(poly)
    else:
        roots_int = _factor_roots(poly)
    roots_int = sorted(roots_int)
    roots = field(np.array(roots_int, dtype=np.int64 if field.order <= 2**63 else object))
    if not multiplicity:
        return roots
    return roots, np.array([_root_multiplicity(poly, r) for r in roots_int], dtype=np.int64)


def _chien_roots(poly: Poly):
    """The elements where poly vanishes: one evaluation over the whole field
    on the device, one read-back of the mask."""
    from ..ops._kernels import get_ops, kernel_mode
    from ..ops._poly_eval import evaluate

    field = poly.field
    x = field.elements
    zero = get_ops(field._meta, kernel_mode(field)).is_zero(evaluate(poly, x)._data)
    return [int(e) for e in np.asarray(x._masked(zero), dtype=np.int64)]


def _factor_roots(poly: Poly):
    """The roots from the linear factors of g = gcd(f, x^q - x), on the host."""
    from ._factor import equal_degree_factors

    field = poly.field
    F = _hf(field)
    f = poly._asc()
    f = hp.scalar_mul(F, f, F.reciprocal(f[-1]))
    xq = hp.pow_mod(F, [0, 1], field.order, f)
    g = hp.gcd(F, f, hp.sub(F, xq, [0, 1]))
    if hp.degree(g) < 1:
        return []
    return [F.negative(lf._asc()[0]) for lf in equal_degree_factors(Poly._from_asc(g, field), 1)]


def _root_multiplicity(poly: Poly, root: int) -> int:
    """The multiplicity of a root by division by (x - root), exact in any
    characteristic."""
    linear = Poly([1, _hf(poly.field).negative(root)], field=poly.field)
    mult, cur = 0, poly
    while cur.degree >= 1:
        quotient, r = divmod(cur, linear)
        if not r.is_zero:
            break
        mult += 1
        cur = quotient
    return mult
