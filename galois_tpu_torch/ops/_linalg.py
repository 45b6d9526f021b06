"""Field matrix products: the public ``matmul`` and the exact prime-field
matmul on balanced int8 digit planes.

Port of ``matmul``, ``_gf2_matmul``, ``_generic_matmul`` and the plane
helpers of ``galois_tpu/ops/_linalg.py``. ``matmul`` follows NumPy's rules
(1-D promotion, batch broadcasting) and routes by field: GF(2) to a float32
product mod 2, GF(p) to ``_prime_matmul``, GF(2^m) to the bit planes of
``ops/_binary_matmul.py``, GF(p^m) to the digit planes of
``ops/_digit_matmul.py`` where their sums stay exact, and anything else to
a loop of field multiply-adds over the contraction axis, which also takes
GF(2^m), m > 32, and the digit fields. Limb prime fields (p > 2^32) go to
the digit planes of ``ops/_limb_matmul.py``.

The Gaussian elimination family (``row_reduce``, ``matrix_rank``, ``inv``,
``det``, ``plu_decompose``, ``lu_decompose``, ``solve``) keeps the JAX
package's routes: a matrix of at most 4096 elements is reduced exactly on
the host in Python ints, a larger one on its device by a masked column loop
(``_row_reduce_data``, ``_plu_data``, ``_det_data``) whose steps never read
back to the host. The JAX package's ``lax.cond(found, ...)`` becomes masks:
a column without a pivot zeroes the rank-1 update's factors and keeps the
pivot row, so every step launches the same kernels.

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
from ._kernels import get_ops, kernel_mode, mulmod
from ._limbs import _i16, _where

__all__ = ["matmul", "row_reduce", "inv", "det", "solve", "matrix_rank", "lu_decompose", "plu_decompose"]

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
    out = _matmul_data(cls._meta, kernel_mode(cls), A._data, B._data, A.ndim == 1, B.ndim == 1)
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
        # planar storage (w, ..., M, K): the limb or digit axis leads and rides as a batch axis
        from ._limb_matmul import limb_matmul, supports_generic

        out = limb_matmul(meta, a, b) if supports_generic(meta) else _generic_matmul(get_ops(meta, mode), a, b)
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
    """Field multiply-adds over the contraction axis: the int-storage fields
    the plane products do not take, and the planar GF(2^m), m > 32, and
    digit fields (the storage axis rides as a batch axis)."""
    shape = torch.broadcast_shapes(a.shape[:-1] + (1,), b.shape[:-2] + (1, b.shape[-1]))
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    for k in range(a.shape[-1]):
        out = ops.add(out, ops.multiply(a[..., :, k : k + 1], b[..., k : k + 1, :]))
    return out


# ----------------------------------------------------------------------
# Gaussian elimination family
# ----------------------------------------------------------------------
#
# Storage layouts of an (M, N) matrix: int (M, N); planar limbs or digits (w, M, N).
# Column j is a[..., j] in both; a column broadcasts against the matrix as
# col.unsqueeze(-1), a row as row.unsqueeze(-2), and element masks of shape
# (M, N) or (M,) right-align under the limb axis. So of the JAX package's
# layout helpers only the row access, which depends on the row axis, is
# needed here (the port keeps its digits planar too).

# Matrices of at most this many elements are reduced exactly on the host,
# as in the JAX package (its literal 4096 in row_reduce, matrix_rank and inv).
_DEVICE_LINALG_CUTOFF = 4096

# With more columns than rows, _row_reduce_data reads its pivot count back
# at column M - 1 and every this many columns after, and stops once every
# row holds a pivot: no later column can change the matrix then. The loop is
# bound by its host launches, so a read-back waits for a short queue: on an
# H100, a 1664 x 8192 GF(2) reduction that never reaches full rank took as
# long at 16 as at 256, and at 1 about 10% longer (scripts/linalg_timing.py).
_EXIT_CHECK_EVERY = 16


def _rows_axis(meta) -> int:
    return 1 if meta.storage_first else 0


def _row(a, i, meta):
    """Row i (a Python int or a 0-d index tensor) of the matrix storage a."""
    ax = _rows_axis(meta)
    if isinstance(i, int):
        return a.select(ax, i)
    return _i16(a).index_select(ax, i.reshape(1)).squeeze(ax).view(a.dtype)


def _set_row(a, i, row, meta) -> None:
    """In place: row i (a 0-d index tensor) of a becomes ``row``."""
    ax = _rows_axis(meta)
    _i16(a).index_copy_(ax, i.reshape(1), _i16(row).unsqueeze(ax))


def _swap(a, pair, ax: int) -> None:
    """In place: the two rows (ax 0) or columns (ax 1; planar storage one
    axis further) of a that ``pair`` (a 2-element index tensor) names
    exchange, through a snapshot of both, so that neither write reads an
    overwritten one (equal indices write the same row twice)."""
    _i16(a).index_copy_(ax, pair.flip(0), _i16(a).index_select(ax, pair))


def _keep(mask, x):
    """x where ``mask`` holds, 0 elsewhere: the int reprs times the mask, one
    launch (uint16 limbs, which torch cannot multiply, by a select)."""
    if x.dtype == torch.uint16:
        return _where(mask, x, torch.zeros_like(x))
    return x * mask


def _field_reduce(op, x, dim: int):
    """Tree-halving reduction of x along storage axis ``dim`` with the field
    op (``ops.add`` or ``ops.multiply``): about log2 of its length levels,
    not a chain of dependent steps (the JAX package's ``_field_sum``)."""
    size = x.shape[dim]
    while size > 1:
        half = size // 2
        head = op(x.narrow(dim, 0, half), x.narrow(dim, half, half))
        x = torch.cat([head, x.narrow(dim, 2 * half, 1)], dim) if size % 2 else head
        size = half + size % 2
    return x.squeeze(dim)


def row_reduce(A, ncols=None):
    """Reduced row echelon form over the first ``ncols`` columns (reference:
    src/galois/_domains/_linalg.py:316-352). Small matrices are reduced
    exactly on the host, larger ones, and every one while capturing, on
    their device."""
    cls = type(A)
    if A.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {A.ndim}-D.")
    ncols = A.shape[1] if ncols is None else int(ncols)
    if _on_host(A):
        R, _, _ = _host_row_reduce(cls, np.asarray(A, dtype=object), ncols)
        return cls(R, dtype=A._dtype, device=A.device)
    out, _ = _row_reduce_data(cls._meta, kernel_mode(cls), A._data, ncols)
    return cls._view(out, A._dtype)


def _captured(A) -> bool:
    """Whether the FieldArray A's work is being captured into a CUDA graph
    (``fields/_array.py::_capturing``)."""
    from ..fields import _array

    return _array._capturing(A._data)


def _on_host(A) -> bool:
    """Whether the elimination family takes its exact host route: for
    matrices of at most ``_DEVICE_LINALG_CUTOFF`` elements, unless A is
    being captured (as the JAX package takes its device route for a
    tracer)."""
    return A.size <= _DEVICE_LINALG_CUTOFF and not _captured(A)


def _host_row_reduce(cls, Anp, ncols):
    """Exact host RREF. Returns (matrix, rank, pivot_cols)."""
    from ..fields._hostfield import get_host_field

    hf = get_host_field(cls._meta)
    M = [[int(v) for v in row] for row in Anp]
    rows = len(M)
    pivots = []
    r = 0
    for c in range(ncols):
        piv = next((i for i in range(r, rows) if M[i][c] != 0), None)
        if piv is None:
            continue
        M[r], M[piv] = M[piv], M[r]
        inv_ = hf.reciprocal(M[r][c])
        M[r] = [hf.multiply(v, inv_) for v in M[r]]
        for i in range(rows):
            if i != r and M[i][c] != 0:
                f = M[i][c]
                M[i] = [hf.subtract(v, hf.multiply(f, w)) for v, w in zip(M[i], M[r])]
        pivots.append(c)
        r += 1
        if r == rows:
            break
    return np.array(M, dtype=object), r, pivots


def _row_reduce_data(meta, mode: str, a, ncols: int):
    """RREF of the matrix storage ``a`` over its first ``ncols`` columns, on
    a's device: (R, rank), rank a 0-d int64 tensor. ``a`` is copied first
    and never written.

    Division-free column steps, then one normalization. Step j finds the
    first row i at or below the pivot row with a nonzero d in column j (a
    masked min), moves the pivot row's old content to row i, and replaces
    every other row r by d a_r - a_rj prow, where prow, row i's content,
    goes to the pivot row: the row space is kept (d != 0) and column j is 0
    off the pivot row. A column without a pivot takes d = 1 and factors 0
    and changes nothing. At the end each pivot row is divided by its
    leading element, and every other row by the product of all the steps'
    d, by which it was scaled: one reciprocal of M + 1 elements. The JAX
    package divides at every step instead; the RREF is the same, and no
    step waits on a reciprocal (over GF(2^31 - 1) and Goldilocks a Fermat
    ladder of 59 and 125 launches). Per column that is about 22 torch
    launches and two products of the field (GF(2^m <= 8): two K8 launches,
    the outer product reading its broadcast operands by stride), and no
    read-back; per call, one reciprocal (K8-A), one more product and a tree
    of about log2(ncols) products. With more columns than rows the pivot
    count is read back at column M - 1 and every ``_EXIT_CHECK_EVERY``
    columns after, and the loop stops once every row holds a pivot; not
    while capturing, when it runs every column."""
    from ..fields import _array

    ops = get_ops(meta, mode)
    early_exit = not _array._capturing(a)
    ax = _rows_axis(meta)
    M = a.shape[ax]
    a = a.clone()
    rows = torch.arange(M, device=a.device)
    pivot_row = torch.zeros((), dtype=torch.int64, device=a.device)
    one = ops.one_like(_row(a, 0, meta)[..., 0])
    d_steps = one.unsqueeze(-1).expand(one.shape + (ncols + 1,)).clone()  # each step's d; one 1 to spare
    for j in range(ncols):
        nz = torch.logical_not(ops.is_zero(a[..., j]))
        i = torch.where(nz & (rows >= pivot_row), rows, M).min()
        found = i < M
        pr = pivot_row.clamp(max=M - 1)
        i = torch.where(found, i, pr)
        prow = _row(a, i, meta)
        _set_row(a, i, _row(a, pr, meta), meta)
        d = _where(found, prow[..., j], one)
        d_steps[..., j].copy_(d)
        factor = _keep((rows != pr) & found, a[..., j])
        a = ops.subtract(ops.multiply(a, d), ops.multiply(factor.unsqueeze(-1), prow.unsqueeze(-2)))
        _set_row(a, pr, prow, meta)
        pivot_row = pivot_row + found
        if early_exit and M - 1 <= j < ncols - 1 and (j - M + 1) % _EXIT_CHECK_EVERY == 0 and int(pivot_row) == M:
            break
    # a pivot row's leading element is its first nonzero; a zero row's gathered 0 is scaled by anything
    lead = torch.logical_not(ops.is_zero(a)).to(torch.int32).argmax(dim=-1, keepdim=True)
    lead = _i16(a).gather(-1, lead.expand(a.shape[:-1] + (1,))).view(a.dtype)
    scale = ops.reciprocal(torch.cat([lead.squeeze(-1), _field_reduce(ops.multiply, d_steps, -1).unsqueeze(-1)], -1))
    scale = _where(rows < pivot_row, scale[..., :M], scale[..., M:])
    return ops.multiply(a, scale.unsqueeze(-1)), pivot_row


def matrix_rank(A) -> int:
    """The rank, an int; while capturing, the 0-d int64 tensor on the
    device."""
    cls = type(A)
    if _on_host(A):
        _, rank, _ = _host_row_reduce(cls, np.asarray(A, dtype=object), A.shape[1])
        return rank
    _, pivots = _row_reduce_data(cls._meta, kernel_mode(cls), A._data, A.shape[1])
    return pivots if _captured(A) else int(pivots)


def inv(A):
    """Matrix inverse by row-reducing [A | I]
    (reference: src/galois/_domains/_linalg.py:496-525). While capturing
    there is no singularity check: the inverse of a singular A is
    unspecified."""
    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    n = A.shape[0]
    if _on_host(A):
        Anp = np.asarray(A, dtype=object)
        AI = np.concatenate([Anp, np.eye(n, dtype=np.int64).astype(object)], axis=1)
        R, rank, _ = _host_row_reduce(cls, AI, n)
        if rank != n:
            raise np.linalg.LinAlgError("Matrix is singular and cannot be inverted.")
        return cls(R[:, n:], dtype=A._dtype, device=A.device)
    AI = torch.cat([A._data, cls.Identity(n, device=A.device)._data], dim=-1)
    out, pivots = _row_reduce_data(cls._meta, kernel_mode(cls), AI, n)
    if not _captured(A) and int(pivots) != n:
        raise np.linalg.LinAlgError("Matrix is singular and cannot be inverted.")
    return cls._view(out[..., n:].contiguous(), A._dtype)


def _plu_data(meta, mode: str, a):
    """LAPACK-style factorization of the matrix storage ``a`` on its device,
    with first-nonzero pivoting (the reference's plu_decompose_jit,
    src/galois/_domains/_linalg.py:387-426). ``a`` is copied first.

    Returns (lu, perm, swaps): ``lu`` holds the unit-lower factors below the
    diagonal and U on and above it, A[perm] = L @ U, and ``swaps`` (a 0-d
    int64 tensor) counts the row exchanges. A column without a pivot has
    zeros below the diagonal, so its multipliers and its update are 0 with
    no mask, and a singular A gives a U with zeros on its diagonal. Step j
    updates only the block below and right of (j, j); the last row has
    nothing below it and takes no step. Per step: one reciprocal (of a 0
    where the column has no pivot) and two products of the field, and no
    read-back."""
    ops = get_ops(meta, mode)
    ax = _rows_axis(meta)
    n, ncols = a.shape[ax], a.shape[ax + 1]
    a = a.clone()
    rows = torch.arange(n, device=a.device)
    perm = rows.clone()
    swaps = torch.zeros((), dtype=torch.int64, device=a.device)
    for j in range(min(n - 1, ncols)):
        nz = torch.logical_not(ops.is_zero(a[..., j]))
        i = torch.where(nz & (rows >= j), rows, n).min()
        i = torch.where(i < n, i, j)
        pair = torch.stack([i, rows[j]])
        _swap(a, pair, ax)
        _swap(perm, pair, 0)
        swaps = swaps + (i != j)
        below = a[..., j + 1 :, j]
        below.copy_(ops.multiply(below, ops.reciprocal(a[..., j, j])))
        block = a[..., j + 1 :, j + 1 :]
        block.copy_(ops.subtract(block, ops.multiply(below.unsqueeze(-1), a[..., j, j + 1 :].unsqueeze(-2))))
    return a, perm, swaps


def _det_data(meta, mode: str, a):
    """Determinant on the device: PLU, then (-1)^swaps times the product of
    U's diagonal, as a tree of field multiplies (log2 n levels, where the
    JAX package scans n dependent multiplies)."""
    ops = get_ops(meta, mode)
    lu, _, swaps = _plu_data(meta, mode, a)
    prod = _field_reduce(ops.multiply, torch.diagonal(lu, dim1=-2, dim2=-1), -1)
    return _where((swaps & 1) == 1, ops.negative(prod), prod)


def _lu_split(cls, lu, perm, n: int, dtype):
    """Split the packed factorization into (P, L, U) FieldArrays of ``dtype``
    on lu's device, with A = P @ L @ U, P[perm[k], k] = 1."""
    meta = cls._meta
    dev = lu.device
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(lu.shape[-1], device=dev)[None, :]
    lower, diag = rows > cols, rows == cols
    zero = torch.zeros_like(lu)
    L = _where(lower, lu, _where(diag, get_ops(meta, kernel_mode(cls)).one_like(lu), zero))
    U = _where(torch.logical_not(lower), lu, zero)
    oh = (rows == perm[None, :]).to(torch.int64)
    if meta.storage_first:
        oh = torch.cat([oh[None], oh.new_zeros((meta.storage_width - 1, n, n))])
    return cls._view(oh.to(meta.torch_dtype), dtype), cls._view(L, dtype), cls._view(U, dtype)


def det(A):
    """Determinant by PLU: (-1)^swaps times the product of U's diagonal.
    Small matrices are factored exactly on the host, larger ones on their
    device (reference: src/galois/_domains/_linalg.py:434-475)."""
    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    n = A.shape[0]
    if n == 1:
        return A[0, 0]
    if _on_host(A):
        from ..fields._hostfield import get_host_field

        hf = get_host_field(cls._meta)
        _, _, U, swaps = _host_plu(cls, A)
        out = U[0][0]
        for i in range(1, n):
            out = hf.multiply(out, U[i][i])
        return cls(hf.negative(out) if swaps % 2 else out, dtype=A._dtype, device=A.device)
    return cls._view(_det_data(cls._meta, kernel_mode(cls), A._data), A._dtype)


def lu_decompose(A):
    P, L, U = plu_decompose(A)
    if not _captured(A) and not torch.equal(P._data, type(A).Identity(A.shape[0], device=A.device)._data):
        raise ValueError("The LU decomposition of 'A' does not exist. Use the PLU decomposition instead.")
    return L, U


def plu_decompose(A):
    cls = type(A)
    if A.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {A.ndim}-D.")
    if _on_host(A):
        P, L, U, _ = _host_plu(cls, A)
        return tuple(cls(x, dtype=A._dtype, device=A.device) for x in (P, L, U))
    lu, perm, _ = _plu_data(cls._meta, kernel_mode(cls), A._data)
    return _lu_split(cls, lu, perm, A.shape[0], A._dtype)


def _host_plu(cls, A):
    """PLU with first-nonzero pivoting in exact host arithmetic: (P, L, U)
    as lists of Python ints and the swap count (the JAX package's ``_plu``)."""
    from ..fields._hostfield import get_host_field

    n = A.shape[0]
    hf = get_host_field(cls._meta)
    U = [[int(v) for v in row] for row in np.asarray(A, dtype=object)]
    L = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    perm = list(range(n))
    swaps = 0
    for j in range(min(n, len(U[0]) if U else 0)):
        piv = next((i for i in range(j, n) if U[i][j] != 0), None)
        if piv is None:
            continue
        if piv != j:
            U[j], U[piv] = U[piv], U[j]
            perm[j], perm[piv] = perm[piv], perm[j]
            for k in range(j):
                L[j][k], L[piv][k] = L[piv][k], L[j][k]
            swaps += 1
        inv_p = hf.reciprocal(U[j][j])
        for i in range(j + 1, n):
            if U[i][j] != 0:
                factor = hf.multiply(U[i][j], inv_p)
                L[i][j] = factor
                for k in range(len(U[i])):
                    U[i][k] = hf.subtract(U[i][k], hf.multiply(factor, U[j][k]))
    P = [[0] * n for _ in range(n)]
    for row, col in enumerate(perm):
        P[col][row] = 1
    return P, L, U, swaps


def solve(A, b):
    """Solve A x = b (reference: src/galois/_domains/_linalg.py:528-548)."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError(f"Argument 'A' must be square, not {A.shape}.")
    return matmul(inv(A), b)
