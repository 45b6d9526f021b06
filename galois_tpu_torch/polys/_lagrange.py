"""The Lagrange interpolating polynomial, on the host.

Port of ``galois_tpu/polys/_lagrange.py``."""

from __future__ import annotations

import numpy as np

from . import _hostpoly as hp
from ._poly import Poly, _hf

__all__ = ["lagrange_poly"]


def lagrange_poly(x, y) -> Poly:
    """The unique polynomial of degree < k through the k points (x_i, y_i)."""
    from ..fields._array import FieldArray

    if not isinstance(x, FieldArray) or not isinstance(y, FieldArray):
        raise TypeError("Arguments 'x' and 'y' must be FieldArrays.")
    field = type(x)
    if type(y)._meta != field._meta:
        raise TypeError("Arguments 'x' and 'y' must be over the same field.")
    if x.ndim != 1 or y.ndim != 1 or x.shape != y.shape:
        raise ValueError("Arguments 'x' and 'y' must be 1-D with equal shapes.")
    xs = [int(v) for v in np.asarray(x, dtype=object)]
    ys = [int(v) for v in np.asarray(y, dtype=object)]
    if len(set(xs)) != len(xs):
        raise ValueError("Argument 'x' must have unique elements.")
    F = _hf(field)
    result = [0]
    for j, (xj, yj) in enumerate(zip(xs, ys)):
        # ell_j(x) = prod_{i != j} (x - x_i) / (x_j - x_i)
        num, denom = [1], 1
        for i, xi in enumerate(xs):
            if i != j:
                num = hp.mul(F, num, [F.negative(xi), 1])
                denom = F.multiply(denom, F.subtract(xj, xi))
        result = hp.add(F, result, hp.scalar_mul(F, num, F.multiply(yj, F.reciprocal(denom))))
    return Poly._from_asc(result, field)
