"""Finite-field convolution (np.convolve).

Port of ``galois_tpu/ops/_convolve.py`` in a batched form. The strategy is
chosen by the JAX package's tests, with n >= m the operands' lengths:

- the NTT, when m >= 64, storage is int and N (N.bit_length() + 4) < n m,
  N from ``_ntt_size``: both zero-padded operands go through one batched
  ``fft_data`` call (batch 2, one plan), then a pointwise product and one
  inverse transform;
- an exact int64 multiply-accumulate for GF(p), p odd, when
  m (p - 1)^2 < 2^63;
- field multiply-adds otherwise (limb fields among them).

The last two take the shorter operand's taps in chunks: one outer product
of a chunk of c taps with the longer operand (through ``ops.multiply``,
so each field reaches its multiply kernel), skewed so that every
anti-diagonal becomes a column, and one sum over the chunk's rows (int64,
or a tree of field additions). A product's launches grow with m / c and
log c, not with m; c is set by ``_OUTER_BYTES``.
"""

from __future__ import annotations

import torch

from ..fields._meta import STORAGE_INT, FieldMeta
from ._kernels import get_ops, kernel_mode

__all__ = ["convolve"]

# Memory budget of one chunk's outer product and its skewed copy, with the
# limb multiply's int64 planes for fields wider than 4 limbs.
_OUTER_BYTES = 2**30


def convolve(a, b, mode: str = "full"):
    """np.convolve of two 1-D FieldArrays of one field, on their device."""
    from ..fields._array import FieldArray

    if not isinstance(a, FieldArray) and not isinstance(b, FieldArray):
        raise TypeError("At least one argument must be a FieldArray.")
    cls = type(a) if isinstance(a, FieldArray) else type(b)
    dev = a.device if isinstance(a, FieldArray) else b.device
    a = a if isinstance(a, FieldArray) else cls(a, device=dev)
    b = b if isinstance(b, FieldArray) else cls(b, device=dev)
    if mode != "full":
        raise ValueError(f"Argument 'mode' must be 'full', not {mode!r} (matching the reference).")
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("Arguments must be 1-D arrays.")
    return cls._view(_convolve_data(cls, a._data, b._data), a._dtype)


def _ntt_size(meta: FieldMeta, out_len: int):
    """Smallest N >= out_len with N | q - 1 built from the prime factors
    <= 64 of q - 1, or None."""
    from ..nt import factors as int_factors

    primes, exps = int_factors(meta.order - 1)
    divs = [1]
    for p, e in zip(primes, exps):
        if p <= 64:
            divs = [d * p**k for d in divs for k in range(e + 1)]
    return next((d for d in sorted(divs) if d >= out_len), None)


def _skew(x: torch.Tensor) -> torch.Tensor:
    """(..., c, n) -> (..., c, n + c - 1) with row j shifted right by j and
    zeros elsewhere: column k holds the anti-diagonal x[j, k - j]."""
    c, n = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    z = x.new_zeros(lead + (c, n + c))
    z[..., :n] = x
    return z.reshape(lead + (c * (n + c),))[..., : c * (n + c - 1)].reshape(lead + (c, n + c - 1))


def _sum_rows(ops, x: torch.Tensor) -> torch.Tensor:
    """Field sum over axis -2 by a binary tree of ``ops.add``."""
    r = x.shape[-2]
    while r > 1:
        half = r // 2
        s = ops.add(x[..., :half, :], x[..., half : 2 * half, :])
        x = torch.cat([s, x[..., 2 * half :, :]], dim=-2) if r % 2 else s
        r = half + r % 2
    return x[..., 0, :]


def _convolve_data(cls, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    meta = cls._meta
    ops = get_ops(meta, kernel_mode(cls))
    w = meta.storage_width if meta.storage_first else 0
    n, m = a.shape[-1], b.shape[-1]  # the coefficient axis is the last of the storage
    if m > n:
        a, b = b, a
        n, m = m, n
    out_len = n + m - 1

    if m >= 64 and meta.storage == STORAGE_INT:
        N = _ntt_size(meta, out_len)
        if N is not None and N * (N.bit_length() + 4) < n * m:
            from ._ntt import fft_data

            both = a.new_zeros((2, N))
            both[0, :n] = a
            both[1, :m] = b
            X = fft_data(cls, both, N)
            return fft_data(cls, ops.multiply(X[0], X[1]), N, inverse=True)[:out_len]

    p = meta.characteristic
    exact = meta.degree == 1 and p != 2 and meta.storage == STORAGE_INT and m * (p - 1) ** 2 < 2**63
    # bytes an outer-product element takes: itself, its skewed copy and a
    # tree level (int64 on the exact path), with the limb multiply's planes
    per = 32 if exact else 4 * a.element_size() * max(1, w) + (96 * w if w > 4 else 0)
    c = max(1, min(m, _OUTER_BYTES // (per * 2 * n)))
    if exact:
        a64 = a.to(torch.int64)
        acc = torch.zeros(out_len, dtype=torch.int64, device=a.device)
        for j0 in range(0, m, c):
            bj = b[j0 : j0 + c].to(torch.int64)
            acc[j0 : j0 + n + bj.shape[0] - 1] += _skew(bj[:, None] * a64[None, :]).sum(dim=0)
        return (acc % p).to(a.dtype)

    # field multiply-adds: a (..., n) against chunks of b's taps
    out = a.new_zeros(a.shape[:-1] + (out_len,))
    for j0 in range(0, m, c):
        bj = b[..., j0 : j0 + c]
        part = _sum_rows(ops, _skew(ops.multiply(a.unsqueeze(-2), bj.unsqueeze(-1))))
        seg = out[..., j0 : j0 + part.shape[-1]]
        seg.copy_(ops.add(seg, part))
    return out
