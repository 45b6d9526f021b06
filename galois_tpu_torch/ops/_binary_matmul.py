"""GF(2^m) matrix multiply on 0/1 bit planes.

Port of ``galois_tpu/ops/_binary_matmul.py``. Writing elements as bit
vectors, coefficient k of the product polynomial is

    P_k = XOR over n of AND(A_i, B_j) for i + j = k
        = parity(sum_n A_i[., n] * B_j[n, .])

so all m^2 bit-plane products come from ONE stacked matrix product
(m*M, K) @ (K, m*N), whose block (i, j) is A_i @ B_j; the 2m - 1 product
bits then fold back to m bits through the reduction rows of f mod 2.

The JAX package runs that product as a plain ``jnp.matmul`` outside any
Pallas kernel, and so does this port with ``torch.matmul``, on float32 0/1
planes: every sum is an integer at most K < 2^24, exact in float32 (TF32,
where a caller enables it, is exact on 0/1 inputs too, with float32
accumulation). CUDA has no int8 ``torch.matmul``; bf16 or fp16 outputs would
round sums above 256, which BCH(511) reaches. Large products run in row
chunks, so that the float32 block stays near 1 GB.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tracing import span
from ..fields._meta import STORAGE_INT, FieldMeta

__all__ = ["binary_matmul", "supports"]

_CHUNK_ELEMS = 2**28  # float32 elements of the stacked product per chunk


def supports(meta: FieldMeta, K: int) -> bool:
    return (
        meta.characteristic == 2
        and 1 < meta.degree <= 32
        and meta.storage == STORAGE_INT
        and K < 2**24  # parity sums exact in float32
    )


@functools.lru_cache(maxsize=None)
def _reduction_rows(meta: FieldMeta) -> np.ndarray:
    """(m - 1, m) 0/1 matrix: product bit m + k folds into these output bits."""
    m = meta.degree
    f = meta.irreducible_poly_int
    rows = []
    for k in range(m - 1):
        v = 1 << (m + k)  # x^(m+k) mod f as bits
        for i in range(2 * m - 2, m - 1, -1):
            if (v >> i) & 1:
                v ^= f << (i - m)
        rows.append([(v >> j) & 1 for j in range(m)])
    return np.array(rows, dtype=np.int64)


def binary_matmul(meta: FieldMeta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (..., M, K), b: (..., K, N) storage tensors of GF(2^m) int reprs;
    returns (..., M, N) in a's dtype.

    The span ``gf.binary_matmul`` covers every chunk of the product, its
    GEMMs and its passes; whatever replaces this product keeps the name."""
    m = meta.degree
    M, N = a.shape[-2], b.shape[-1]
    rows = max(1, _CHUNK_ELEMS // max(1, m * m * N))
    with span("gf.binary_matmul", a):
        if a.ndim == 2 and b.ndim == 2 and M > rows:
            return torch.cat([_binary_matmul(meta, a[s : s + rows], b) for s in range(0, M, rows)])
        return _binary_matmul(meta, a, b)


def _binary_matmul(meta: FieldMeta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = meta.degree
    M, N = a.shape[-2], b.shape[-1]
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    astack = torch.cat([((a32 >> i) & 1).to(torch.float32) for i in range(m)], dim=-2)  # (..., m*M, K)
    bstack = torch.cat([((b32 >> j) & 1).to(torch.float32) for j in range(m)], dim=-1)  # (..., K, m*N)
    big = (torch.matmul(astack, bstack).to(torch.int32) & 1).to(torch.uint8)  # parity of each A_i @ B_j

    def block(i, j):
        return big[..., i * M : (i + 1) * M, j * N : (j + 1) * N]

    prod_bits = []
    for k in range(2 * m - 1):
        acc = None
        for i in range(max(0, k - m + 1), min(m, k + 1)):
            t = block(i, k - i)
            acc = t if acc is None else acc ^ t
        prod_bits.append(acc)

    R = _reduction_rows(meta)
    out = torch.zeros(prod_bits[0].shape, dtype=torch.int64, device=a.device)
    for j in range(m):
        bit = prod_bits[j]
        for k in range(m - 1):
            if R[k, j]:
                bit = bit ^ prod_bits[m + k]
        out |= bit.to(torch.int64) << j
    return out.to(a.dtype)
