"""Batched polynomial evaluation on the device.

Port of ``galois_tpu/ops/_poly_eval.py``: Horner's rule over a whole field
array, one elementwise field op per step, on the array's device. The
coefficients travel as a small storage tensor. In the 'python-calculate'
mode ``evaluate`` runs Horner on exact host ints instead, as the JAX package.

- Fewer than 64 coefficients: plain Horner, n multiply-adds.
- Otherwise the two-level Horner of the JAX package: with c = isqrt(n) and
  k = ceil(n / c) chunks, f(x) = sum_i C_i(x) (x^c)^i. An inner Horner of c
  steps evaluates all k chunk polynomials C_i at once on a (k, ...) batch,
  x^c comes by square-and-multiply, and an outer Horner of k steps combines
  them. The JAX package does this to shorten a sequential scan; on the card
  it also means fewer, larger launches: at 256 coefficients 16 + 4 + 16 = 36
  multiplies instead of 256. In the inner step x is broadcast against the k
  chunks; the multiply kernels K9 and K10 take it with its period instead of
  k copies (``ops/_elementwise.py::_periodic``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fields._meta import FieldMeta
from ._kernels import get_ops, kernel_mode

__all__ = ["evaluate", "evaluate_data"]

_TWO_LEVEL_MIN = 64  # coefficients; below this, plain Horner


def _horner(ops, meta: FieldMeta, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial with descending coefficients ``coeffs``
    (storage of shape (n,), or (L, n) for planar limbs) at every element of
    the storage tensor ``x``."""
    lead = 1 if meta.storage_first else 0  # the planar limb axis
    n = coeffs.shape[lead]

    def at(t, i, axis=0):
        """Index i of element axis ``axis`` of a storage tensor."""
        return t.select(lead + axis, i)

    if n < _TWO_LEVEL_MIN:
        acc = ops.zero_like(x)
        for j in range(n):
            acc = ops.add(ops.multiply(acc, x), at(coeffs, j))
        return acc

    elem_nd = x.ndim - lead
    c = max(1, math.isqrt(n))
    k = -(-n // c)
    # ascending degrees, zero-padded at the top (in int64: torch's uint16
    # has no flip or cat)
    asc = coeffs.to(torch.int64).flip(lead)
    pad = torch.zeros(coeffs.shape[:lead] + (k * c - n,), dtype=torch.int64, device=coeffs.device)
    asc = torch.cat([asc, pad], dim=lead).to(coeffs.dtype)
    # B[i, j] = coefficient of x^(i c + j), with unit axes for x's elements
    B = asc.reshape(coeffs.shape[:lead] + (k, c) + (1,) * elem_nd)
    xb = x.unsqueeze(lead)  # (1, ...) against the k chunks
    acc = ops.zero_like(xb.expand(x.shape[:lead] + (k,) + x.shape[lead:]))
    for j in reversed(range(c)):
        acc = ops.add(ops.multiply(acc, xb), at(B, j, axis=1))

    y, sq, e = None, x, c  # y = x^c
    while e:
        if e & 1:
            y = sq if y is None else ops.multiply(y, sq)
        e >>= 1
        if e:
            sq = ops.multiply(sq, sq)

    out = ops.zero_like(x)
    for i in reversed(range(k)):
        out = ops.add(ops.multiply(out, y), at(acc, i))
    return out


def evaluate(poly, x):
    """Evaluate ``poly`` at the FieldArray ``x`` elementwise, on x's device;
    returns a FieldArray."""
    cls = type(x)
    meta = cls._meta
    if cls._mode == "python-calculate":  # Horner on exact host ints, as the JAX package
        from ..fields._hostfield import get_host_field
        from ..polys import _hostpoly as hp

        hf, asc = get_host_field(meta), poly._asc()
        xi = np.asarray(x, dtype=object)
        out = np.frompyfunc(lambda v: hp.evaluate(hf, asc, int(v)), 1, 1)(xi)
        return cls(out if xi.ndim else int(out), device=x.device)
    poly._ensure_terms()
    coeffs_desc = [0] * (poly.degree + 1)
    for d, c in zip(poly._degrees, poly._coeffs):
        coeffs_desc[poly.degree - d] = c
    data = x._data
    scalar = x.ndim == 0
    if scalar:
        data = data[:, None] if meta.storage_first else data[None]
    out = evaluate_data(meta, kernel_mode(cls), coeffs_desc, data)
    if scalar:
        out = out[:, 0] if meta.storage_first else out[0]
    return cls._view(out, x._dtype)


def evaluate_data(meta: FieldMeta, mode: str, coeffs_desc, data: torch.Tensor) -> torch.Tensor:
    """Raw-data variant for internal callers: descending int-repr
    coefficients, a storage tensor in, a storage tensor out."""
    from ..fields._array import _ints_to_storage

    carr = _ints_to_storage(meta, np.asarray(list(coeffs_desc), dtype=object), data.device)
    return _horner(get_ops(meta, mode), meta, carr, data)
