"""Minimal polynomial of a matrix on one vector, on its device.

Port of the contract of ``galois_tpu/ops/_minpoly.py::krylov_minpoly_data``:
for a vector v, the monic generator m_v of the first linear dependence in
[v, Av, A^2 v, ...] divides the minimal polynomial of A; the caller lcm's
over a few vectors and VERIFIES m(A) == 0, falling back to the deterministic
host path (fields/_methods.py) if needed, so the randomness never
compromises correctness.

The JAX package nests a loop over n + 1 echelon slots inside a scan over
n + 1 Krylov rows: about n^2 dependent vector steps, which eager torch
would launch one by one. Here:

1. the n + 1 Krylov vectors come from about 2 log2 n field matrix products
   (``_linalg._matmul_data``) by doubling: K holds A^i v for i < c, and
   [K, A^c K] for i < 2c, with A^c squared between the steps;
2. ``_linalg._row_reduce_data`` reduces the n x (n + 1) matrix with the
   Krylov vectors as columns. The first d vectors are independent and every
   later one depends on them, so the rank is d, the pivots are columns
   0..d-1, and column d of the reduced matrix holds the coordinates c of
   A^d v over them: m_v = x^d - sum_i c_i x^i.

The first dependence is unique, so the result is the JAX function's.
"""

from __future__ import annotations

import torch

from ..fields._meta import STORAGE_INT, FieldMeta
from ._kernels import get_ops
from ._linalg import _matmul_data, _row_reduce_data

__all__ = ["krylov_minpoly_data", "supports"]


def supports(meta: FieldMeta) -> bool:
    return meta.storage == STORAGE_INT


def krylov_minpoly_data(meta: FieldMeta, mode: str, a, v):
    """a: (n, n), v: (n,) int storage on one device.

    Returns (coeffs, d): coeffs (n+2,) ascending with coeffs[d] == 1, zeros
    above d, and sum_i coeffs[i] A^i v == 0; d, a 0-d int64 tensor, the
    degree of the (A, v) minimal polynomial."""
    ops = get_ops(meta, mode)
    n = a.shape[0]
    K, Ac = v[:, None], a
    while K.shape[1] < n + 1:
        K = torch.cat([K, _matmul_data(meta, mode, Ac, K, False, False)], dim=1)
        if K.shape[1] < n + 1:
            Ac = _matmul_data(meta, mode, Ac, Ac, False, False)
    R, d = _row_reduce_data(meta, mode, K[:, : n + 1], n + 1)
    coeffs = torch.zeros((n + 2,), dtype=a.dtype, device=a.device)
    coeffs[:n] = ops.negative(R.index_select(1, d.reshape(1)).squeeze(1))
    coeffs.index_fill_(0, d.reshape(1), 1)
    return coeffs, d
