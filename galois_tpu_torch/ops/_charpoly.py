"""Characteristic polynomial of a square matrix on its device.

Port of ``galois_tpu/ops/_charpoly.py`` for int storage, in two stages:

1. Similarity reduction to upper Hessenberg form: Gaussian similarity
   transforms with first-nonzero pivoting, masked like
   ``_linalg._row_reduce_data`` (a column without a pivot runs the same
   launches with its factors 0, and no step reads back to the host).
2. The leading-principal-minor recurrence for det(xI - H) of a Hessenberg
   matrix: p_k = (x - H[k-1,k-1]) p_{k-1}
                 - sum_i H[i-1,k-1] (prod_{j=i-1}^{k-2} H[j+1,j]) p_{i-1}.

Where the JAX package scans with traced indices, the loops here run in
Python with the step a Python int: the row and column swaps of stage 1
exchange two rows and two columns in place (the JAX package gathers the
whole matrix twice), and stage 2's masks over the rows r <= k - 2 become
slices, so step k touches k - 1 rows of the recurrence, not n. The sums
of products (stage 1's matrix-vector product H f, stage 2's weighted sum of
earlier rows) are trees of field adds over a field product
(``_linalg._field_reduce``, the JAX package's ``_field_sum``). The result
is the characteristic polynomial, which is unique, so it equals the JAX
package's and the host Berkowitz loop's.
"""

from __future__ import annotations

import torch

from ..fields._meta import STORAGE_INT, FieldMeta
from ._kernels import get_ops
from ._linalg import _field_reduce, _keep, _swap

__all__ = ["charpoly_data", "supports"]


def supports(meta: FieldMeta) -> bool:
    return meta.storage == STORAGE_INT


def charpoly_data(meta: FieldMeta, mode: str, a):
    """a: (n, n) int-storage matrix -> (n+1,) ASCENDING char-poly coeffs, on
    a's device (a is not written)."""
    ops = get_ops(meta, mode)
    n = a.shape[0]
    H = a.clone()
    rows = torch.arange(n, device=a.device)

    # ---- stage 1: upper Hessenberg by similarity transforms ----
    for j in range(n - 2):
        nz = torch.logical_not(ops.is_zero(H[:, j]))
        i = torch.where(nz & (rows > j), rows, n).min()
        pair = torch.stack([torch.where(i < n, i, j + 1), rows[j + 1]])
        _swap(H, pair, 0)
        _swap(H, pair, 1)
        # H[j+1, j] is 0 only where column j has nothing below it: then f is 0
        f = _keep(rows > j + 1, ops.multiply(H[:, j], ops.reciprocal(H[j + 1, j])))
        # row operations H -= f (x) H[j+1, :], then the similarity's column
        # update H[:, j+1] += H @ f
        H = ops.subtract(H, ops.multiply(f[:, None], H[j + 1][None, :]))
        mv = _field_reduce(ops.add, ops.multiply(H, f[None, :]), 1)
        H[:, j + 1] = ops.add(H[:, j + 1], mv)

    # ---- stage 2: the minor recurrence on the Hessenberg matrix ----
    # P[r] holds the ascending coeffs of p_r; w[r] is the running subdiagonal
    # product prod_{j=r}^{k-2} H[j+1, j] (w[k-1] = 1).
    P = torch.zeros((n + 1, n + 1), dtype=a.dtype, device=a.device)
    w = torch.zeros((n + 1,), dtype=a.dtype, device=a.device)
    P[0, 0].fill_(1)  # fill_: an indexed write of a Python scalar copies it from the host
    w[0].fill_(1)
    for k in range(1, n + 1):
        pk1 = P[k - 1]
        shifted = torch.cat([torch.zeros_like(pk1[:1]), pk1[:-1]])  # x p_{k-1}
        pk = ops.subtract(shifted, ops.multiply(pk1, H[k - 1, k - 1]))
        if k >= 2:
            # v[r] = H[r, k-1] w[r] over the rows r <= k - 2
            v = ops.multiply(H[: k - 1, k - 1], w[: k - 1])
            pk = ops.subtract(pk, _field_reduce(ops.add, ops.multiply(v[:, None], P[: k - 1]), 0))
        P[k] = pk
        if k < n:
            # w'[r] = w[r] * H[k, k-1], and w'[k] = 1
            w[:k] = ops.multiply(w[:k], H[k, k - 1])
            w[k].fill_(1)
    return P[n]
