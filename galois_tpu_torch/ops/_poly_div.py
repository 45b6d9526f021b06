"""Polynomial division on the device.

Port of ``galois_tpu/ops/_poly_div.py``: synthetic division by a monic
divisor with a fixed trip count, the device analogue of the reference's
divmod_jit (src/galois/_polys/_dense.py:126-198).

- ``batched_floordiv`` divides a batch of codewords by g(x): the message
  recovery of non-systematic cyclic codes;
- ``poly_divmod_device`` divides one dense Poly by another: ``Poly``'s
  ``divmod``, ``//`` and ``%`` take it above ``_DEVICE_POLY_WORK``
  coefficient operations, as in the JAX package, and the modular power
  ladder through them.

A Python loop over the quotient's coefficients takes the place of the
``lax.scan``; the storage tensor is updated in place on a private copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ._kernels import get_ops, kernel_mode

__all__ = ["batched_floordiv", "poly_divmod_device"]


def _divide(ops, lead: int, r: torch.Tensor, g: torch.Tensor, nq: int) -> torch.Tensor:
    """Synthetic division of the rows of r by the monic g (descending
    coefficients on axis ``lead + 1`` of r and on the last axis of g, which
    broadcasts against a row; ``lead`` planar limb axes first). Leaves the
    remainders in r's last deg g coefficients; returns the nq quotient
    coefficients stacked on r's coefficient axis."""
    ax = lead + 1
    deg = g.shape[-1] - 1
    qs = []
    for i in range(nq):
        qi = r.select(ax, i).clone()  # the step below zeroes it in r
        qs.append(qi)
        seg = r.narrow(ax, i, deg + 1)
        seg.copy_(ops.subtract(seg, ops.multiply(qi.unsqueeze(ax), g)))
    return torch.stack(qs, dim=ax)


def batched_floordiv(codeword, g_poly, ks: int):
    """codeword: FieldArray (B, n), descending coefficients; returns the
    last ``ks`` quotient coefficients of each row divided by the monic g."""
    cls = type(codeword)
    meta = cls._meta
    lead = cls._storage_ndim()
    g = cls(g_poly.coefficients(), device=codeword.device)._data
    n, deg = codeword.shape[-1], g_poly.degree
    q = _divide(get_ops(meta, kernel_mode(cls)), lead, codeword._data.clone(), g.reshape(g.shape[:lead] + (1, -1)), n - deg)
    return cls._view(q[..., max(0, q.shape[-1] - ks) :], codeword._dtype)


def poly_divmod_device(a_poly, b_poly):
    """(quotient, remainder) of two dense Polys, on the default device."""
    from ..polys._poly import Poly

    field = a_poly.field
    ops = get_ops(field._meta, kernel_mode(field))
    lead = field._storage_ndim()
    deg_a, deg_b = a_poly.degree, b_poly.degree
    if deg_a < deg_b:
        return Poly.Zero(field), a_poly
    a = field(a_poly.coefficients())
    b = field(b_poly.coefficients())
    lead_coeff = int(np.asarray(b, dtype=object)[0])
    inv_lead = ops.reciprocal(b[0]._data)
    # a = (q * lead) * b_monic + r: divide by the monic b, then scale the quotient
    b_monic = ops.multiply(b._data, inv_lead) if lead_coeff != 1 else b._data
    r = a._data.clone().unsqueeze(lead)
    q = ops.multiply(_divide(ops, lead, r, b_monic, deg_a - deg_b + 1).squeeze(lead), inv_lead)
    rem = r.squeeze(lead).narrow(lead, deg_a - deg_b + 1, deg_b) if deg_b else ops.zero_like(q.narrow(lead, 0, 1))
    return Poly(field._view(q)), Poly(field._view(rem))
