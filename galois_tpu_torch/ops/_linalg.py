"""Field matrix products: the public ``matmul`` and the exact prime-field
matmul on balanced int8 digit planes.

Port of ``matmul``, ``_gf2_matmul``, ``_generic_matmul`` and the plane
helpers of ``galois_tpu/ops/_linalg.py``. ``matmul`` follows NumPy's rules
(1-D promotion, batch broadcasting) and routes by field: GF(2) to a float32
product mod 2, GF(p) to ``_prime_matmul``, GF(2^m) to the bit planes of
``ops/_binary_matmul.py``, GF(p^m) to the digit planes of
``ops/_digit_matmul.py`` where their sums stay exact, and anything else to
a loop of field multiply-adds over the contraction axis. Limb fields
(p > 2^32) go to the digit planes of ``ops/_limb_matmul.py``. Row
reduction, inverse, determinant and solve are still to be ported.

The prime-field planes: A residue x in
[0, p) maps to its symmetric residue x' = x - p*(x > p//2), |x'| <= p/2, and
x' = sum_i d_i 256^i with balanced digits d_i in [-128, 127]. The plane
products of two operands, summed by diagonal s = i + j, fold back to the
modular product as sum_s D_s * (2^(8s) mod p) mod p.

These are the plain versions the NTT's side kernels (``ops/_plane_matmul.py``)
are held against. Plane products run as float64 matmuls: every partial sum
is an integer of magnitude <= n * K * 128^2 < 2^53, so they are exact on any
device (an int8 matmul wraps, and CUDA has no int64 matmul).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields._meta import STORAGE_INT
from ._kernels import get_ops, mulmod

__all__ = ["matmul"]

_PLANE_BITS = 8
_PLANE_BASE = 1 << _PLANE_BITS
_PLANE_MAXD = _PLANE_BASE // 2  # balanced digit magnitude bound (128)


def balanced_plane_count(p: int) -> int:
    """Smallest digit count whose all-127 value covers the symmetric-residue
    magnitude p/2 (primes within 0.4% of 2^32 need a 5th digit: the top
    balanced digit caps at +127, not +128)."""
    n_planes = 1
    while 127 * ((_PLANE_BASE**n_planes - 1) // (_PLANE_BASE - 1)) < p // 2:
        n_planes += 1
    return n_planes


def balanced_planes_np(x: np.ndarray, p: int) -> np.ndarray:
    """Host-side planes: (n_planes, *x.shape) int8 NumPy stack, for a static
    matmul operand's planes at plan-build time."""
    xs = x.astype(np.int64)
    xs = np.where(xs > p // 2, xs - p, xs)
    out = []
    for _ in range(balanced_plane_count(p)):
        d = ((xs + 128) & 255) - 128
        out.append(d.astype(np.int8))
        xs = (xs - d) >> 8
    return np.stack(out)


def _balanced_planes(x: torch.Tensor, p: int, n_planes: int) -> torch.Tensor:
    """Device-side planes of residues in [0, p): (n_planes, *x.shape) int8."""
    xs = x.to(torch.int64)
    xs = torch.where(xs > p // 2, xs - p, xs)
    out = []
    for _ in range(n_planes):
        d = ((xs + 128) & 255) - 128
        out.append(d.to(torch.int8))
        xs = (xs - d) >> 8
    return torch.stack(out)


def _fold_diagonals(diag, p: int) -> torch.Tensor:
    """2n - 1 exact signed diagonal sums (int64) -> residues in [0, p)."""
    r = None
    for s, d in enumerate(diag):
        term = mulmod(d % p, pow(2, _PLANE_BITS * s, p), p)
        r = term if r is None else (r + term) % p
    return r


def _prime_matmul_planes(a, b, p: int, K: int, a_planes=None, b_planes=None) -> torch.Tensor:
    """Exact (a @ b) mod p as int64 residues. Either operand may be given as
    its precomputed (n, ..., rows, cols) int8 planes instead."""
    n_planes = balanced_plane_count(p)
    if n_planes * K * _PLANE_MAXD**2 >= 2**53:
        raise ValueError(f"Contraction length {K} is too long for exact float64 plane sums.")
    ap = _balanced_planes(a, p, n_planes) if a_planes is None else a_planes
    bp = _balanced_planes(b, p, n_planes) if b_planes is None else b_planes
    af = [ap[i].to(torch.float64) for i in range(n_planes)]
    bf = [bp[j].to(torch.float64) for j in range(n_planes)]
    diag = [None] * (2 * n_planes - 1)
    for i in range(n_planes):
        for j in range(n_planes):
            blk = torch.matmul(af[i], bf[j])
            diag[i + j] = blk if diag[i + j] is None else diag[i + j] + blk
    return _fold_diagonals([d.to(torch.int64) for d in diag], p)


def _prime_matmul(a, b, p: int, K: int, a_planes=None, b_planes=None) -> torch.Tensor:
    """Exact prime-field matmul of int64 residues: one float64 matmul when
    every product sum stays below 2^53, else the plane decomposition."""
    if a_planes is not None or b_planes is not None or (p - 1) ** 2 * K >= 2**53:
        return _prime_matmul_planes(a, b, p, K, a_planes=a_planes, b_planes=b_planes)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64) % p


# ----------------------------------------------------------------------
# The public matmul
# ----------------------------------------------------------------------

def matmul(A, B):
    """Matrix product of two FieldArrays of one field with NumPy matmul
    semantics (1-D promotion, batched broadcasting), on their device."""
    cls = type(A)
    if A.ndim == 0 or B.ndim == 0:
        raise ValueError("matmul is not defined for 0-D inputs.")
    out = _matmul_data(cls._meta, cls._mode, A._data, B._data, A.ndim == 1, B.ndim == 1)
    return cls._view(out, A._dtype)


def _matmul_data(meta, mode: str, a, b, a_vec: bool, b_vec: bool):
    from ._binary_matmul import binary_matmul
    from ._binary_matmul import supports as bin_supports
    from ._digit_matmul import digit_matmul
    from ._digit_matmul import supports as dig_supports

    if a_vec:
        a = a.unsqueeze(-2)
    if b_vec:
        b = b.unsqueeze(-1)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"matmul: contraction lengths differ, {a.shape[-1]} and {b.shape[-2]}.")
    p, K = meta.characteristic, a.shape[-1]
    if meta.storage != STORAGE_INT:
        # planar limbs (L, ..., M, K): the limb axis leads and rides as a batch axis
        from ._limb_matmul import limb_matmul

        out = limb_matmul(meta, a, b)
    elif meta.degree == 1:
        if p == 2:
            out = _gf2_matmul(a, b, K)
        else:
            out = _prime_matmul(a.to(torch.int64), b.to(torch.int64), p, K).to(meta.torch_dtype)
    elif bin_supports(meta, K):
        out = binary_matmul(meta, a, b)
    elif dig_supports(meta, K):
        out = digit_matmul(meta, a, b)
    else:
        out = _generic_matmul(get_ops(meta, mode), a, b)
    if a_vec:
        out = out.squeeze(-2)
    if b_vec:
        out = out.squeeze(-1)
    return out


def _gf2_matmul(a, b, K: int):
    """GF(2): float32 products of 0/1 (exact while K < 2^24), in blocks of
    2^23 whose parities XOR together."""
    blk = 2**23
    acc = None
    for s in range(0, K, blk):
        c = torch.matmul(a[..., s : s + blk].to(torch.float32), b[..., s : s + blk, :].to(torch.float32))
        part = c.to(torch.int32) & 1
        acc = part if acc is None else acc ^ part
    return acc.to(a.dtype)


def _generic_matmul(ops, a, b):
    """Any int-storage field: field multiply-adds over the contraction axis."""
    shape = torch.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, b.shape[-1]))
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for k in range(a.shape[-1]):
        out = ops.add(out, ops.multiply(a[..., :, k : k + 1], b[..., k : k + 1, :]))
    return out
