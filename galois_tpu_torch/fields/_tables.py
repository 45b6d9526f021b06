"""Host-side (NumPy-vectorized) field arithmetic and lookup-table building.

Port of ``galois_tpu/fields/_tables.py``. Tables are built by a
log2(order)-step NumPy doubling: given EXP[0:n], the next block is
EXP[n:2n] = EXP[0:n] * EXP[n], one vectorized field multiply per step. The
``np_*`` ops are exact on int64 for the orders that have tables (<= 2^20).
"""

from __future__ import annotations

import functools

import numpy as np

from ._meta import FieldMeta, LOOKUP_TABLE_MAX_ORDER


# ----------------------------------------------------------------------
# Vectorized NumPy arithmetic on the *integer representation* (int64).
# Valid for order small enough that intermediates fit int64; table building
# only needs order <= 2^20.
# ----------------------------------------------------------------------

def np_multiply(meta: FieldMeta, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized field multiply on int-repr int64 arrays (order <= ~2^20)."""
    p, m = meta.characteristic, meta.degree
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if m == 1:
        return (a * b) % p
    if p == 2:
        res = np.zeros(np.broadcast(a, b).shape, dtype=np.int64)
        for i in range(m):
            res ^= (a << i) * ((b >> i) & 1)
        f = meta.irreducible_poly_int
        for i in range(2 * m - 2, m - 1, -1):
            res ^= (f << (i - m)) * ((res >> i) & 1)
        return res
    # Odd extension: digit-vector convolution + reduction-matrix fold.
    A = _np_int_to_digits(meta, a)  # (..., m) ascending
    B = _np_int_to_digits(meta, b)
    full = np.zeros(np.broadcast(a, b).shape + (2 * m - 1,), dtype=np.int64)
    for i in range(m):
        for j in range(m):
            full[..., i + j] += A[..., i] * B[..., j]
    full %= p
    low, high = full[..., :m], full[..., m:]
    R = meta.reduction_matrix  # (m-1, m)
    out = (low + high @ R) % p
    return _np_digits_to_int(meta, out)


def np_add(meta: FieldMeta, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    p, m = meta.characteristic, meta.degree
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if m == 1:
        return (a + b) % p
    if p == 2:
        return a ^ b
    A = _np_int_to_digits(meta, a)
    B = _np_int_to_digits(meta, b)
    return _np_digits_to_int(meta, (A + B) % p)


def np_negative(meta: FieldMeta, a: np.ndarray) -> np.ndarray:
    p, m = meta.characteristic, meta.degree
    a = np.asarray(a, dtype=np.int64)
    if m == 1:
        return (-a) % p
    if p == 2:
        return a.copy()
    A = _np_int_to_digits(meta, a)
    return _np_digits_to_int(meta, (-A) % p)


def np_subtract(meta: FieldMeta, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np_add(meta, a, np_negative(meta, b))


def np_power(meta: FieldMeta, a: np.ndarray, e: int) -> np.ndarray:
    """Vectorized a**e for a scalar non-negative int exponent."""
    a = np.asarray(a, dtype=np.int64)
    result = np.ones_like(a)
    if e == 0:
        return result
    base = a
    for bit in bin(e)[2:]:
        result = np_multiply(meta, result, result)
        if bit == "1":
            result = np_multiply(meta, result, base)
    return result


def np_reciprocal(meta: FieldMeta, a: np.ndarray) -> np.ndarray:
    return np_power(meta, a, meta.order - 2)


def np_divide(meta: FieldMeta, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np_multiply(meta, a, np_reciprocal(meta, b))


def _np_int_to_digits(meta: FieldMeta, a: np.ndarray) -> np.ndarray:
    """Int repr -> (..., m) base-p digits, ascending degrees."""
    p, m = meta.characteristic, meta.degree
    digits = np.empty(a.shape + (m,), dtype=np.int64)
    x = a.copy()
    for i in range(m):
        digits[..., i] = x % p
        x //= p
    return digits


def _np_digits_to_int(meta: FieldMeta, digits: np.ndarray) -> np.ndarray:
    p, m = meta.characteristic, meta.degree
    weights = p ** np.arange(m, dtype=np.int64)
    return (digits * weights).sum(axis=-1)


# ----------------------------------------------------------------------
# Lookup tables
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build_exp_log(meta: FieldMeta):
    """Build (EXP, LOG) tables as int64 NumPy arrays.

    EXP has length 2*(order-1): EXP[i] = alpha^(i mod (order-1)), doubled so
    kernels can index LOG[a]+LOG[b] (< 2(q-1)) without a modulo
    (same trick as reference src/galois/_domains/_lookup.py:371).
    LOG has length order with LOG[alpha^i] = i; LOG[0] is 0 and must be
    masked by callers.
    """
    q = meta.order
    if q > LOOKUP_TABLE_MAX_ORDER:
        raise ValueError(f"Lookup tables are limited to order <= 2^20, not {q}.")
    alpha = meta.primitive_element_int
    exp = np.array([1], dtype=np.int64)
    while len(exp) < q - 1:
        step = np_multiply(meta, exp[-1:], np.array([alpha], dtype=np.int64))[0]
        exp = np.concatenate([exp, np_multiply(meta, exp, step)])[: q - 1]
    # Sanity: alpha generates the multiplicative group.
    if len(np.unique(exp)) != q - 1:
        raise RuntimeError(
            f"Primitive element {alpha} does not generate the units of {meta.name}."
        )
    log = np.zeros(q, dtype=np.int64)
    log[exp] = np.arange(q - 1, dtype=np.int64)
    exp2 = np.concatenate([exp, exp])
    return exp2, log
