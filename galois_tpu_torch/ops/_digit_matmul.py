"""GF(p^m), p odd, matrix multiply on base-p digit planes.

Port of ``galois_tpu/ops/_digit_matmul.py``, the odd-characteristic sibling
of ``ops/_binary_matmul.py``: digit-convolution coefficient k of the product
is sum over n of A_i[., n] * B_j[n, .] for i + j = k, so one stacked
(m*M, K) @ (K, m*N) matrix product yields every digit-pair block, and the
blocks fold mod p through the field's reduction matrix. The JAX package
gates this on K * (p - 1)^2 < 2^24 (exact float32 sums); the same gate keeps
the routing here, and the product runs in float64, so the sums stay exact
whatever a caller sets for TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields._meta import STORAGE_INT, FieldMeta

__all__ = ["digit_matmul", "supports"]


def supports(meta: FieldMeta, K: int) -> bool:
    p = meta.characteristic
    return p > 2 and meta.degree > 1 and meta.storage == STORAGE_INT and K * (p - 1) ** 2 < 2**24


def digit_matmul(meta: FieldMeta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., M, K), b: (..., K, N) int reprs of GF(p^m) (int storage)."""
    p, m = meta.characteristic, meta.degree
    M, N = a.shape[-2], b.shape[-1]
    a64, b64 = a.to(torch.int64), b.to(torch.int64)

    def digit(x, i):
        return (x // p**i % p).to(torch.float64)

    astack = torch.cat([digit(a64, i) for i in range(m)], dim=-2)
    bstack = torch.cat([digit(b64, j) for j in range(m)], dim=-1)
    big = torch.matmul(astack, bstack).to(torch.int64) % p

    def block(i, j):
        return big[..., i * M : (i + 1) * M, j * N : (j + 1) * N]

    conv = []
    for k in range(2 * m - 1):
        acc = None
        for i in range(max(0, k - m + 1), min(m, k + 1)):
            t = block(i, k - i)
            acc = t if acc is None else acc + t
        conv.append(acc % p)

    # out digit j = conv[j] + sum_k R[k, j] * conv[m + k] (mod p)
    R = np.asarray(meta.reduction_matrix)  # (m - 1, m)
    out = torch.zeros_like(conv[0])
    for j in range(m):
        dig = conv[j]
        for k in range(m - 1):
            if int(R[k, j]):
                dig = dig + int(R[k, j]) * conv[m + k]
        out += dig % p * p**j
    return out.to(a.dtype)
