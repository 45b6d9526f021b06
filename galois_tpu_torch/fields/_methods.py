"""Field methods attached to FieldArray: linear algebra, orders, element
and matrix polynomials, roots of unity.

Port of the parts of ``galois_tpu/fields/_array.py`` and
``galois_tpu/fields/_methods.py`` that the linear codes and the matrix
algebra need:

- the matrix methods ``row_reduce`` (``eye`` "left" or "right"),
  ``lu_decompose``, ``plu_decompose``, ``row_space``, ``column_space``,
  ``left_null_space`` and ``null_space`` (``ops/_linalg.py``; the rank of a
  reduced matrix is counted on its device, with one read-back);
- ``FieldArray.multiplicative_order``: on the device for int storage, with
  the static factorization of q - 1; host ints for limb storage;
- ``minimal_poly`` and ``characteristic_poly`` of a 0-D element (the
  product of (x - c) over its conjugates c, on the host) and of a square
  matrix: for int storage from n = 32 (the char poly, ``ops/_charpoly.py``)
  and above n^2 = 1024 (the min poly, ``ops/_minpoly.py``, verified by
  m(A) == 0) on the matrix's device, else (and in 'python-calculate') the
  JAX package's host loops (Berkowitz; the dependence of I, A, A^2, ...);
- ``primitive_root_of_unity`` and ``primitive_roots_of_unity`` of a field
  class;
- the display tables ``repr_table`` and ``arithmetic_table`` of a field
  class, on host ints.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..nt import factors, totatives
from ..ops import _linalg
from ..ops._kernels import kernel_mode, mulmod
from ._array import FieldArray, FieldArrayMeta, _get_ops, _storage_to_ints
from ._hostfield import get_host_field
from ._meta import STORAGE_DIGITS, STORAGE_INT

__all__ = []


def _attach(owner, name):
    def deco(fn):
        setattr(owner, name, fn)
        return fn

    return deco


@_attach(FieldArray, "multiplicative_order")
def multiplicative_order(self):
    """Order of each unit in the multiplicative group (reference:
    src/galois/_fields/_array.py:1292-1353). Int storage computes on the
    device: for each prime factor of q - 1, the candidate order is divided
    while x^(order / p_i) == 1."""
    meta = self._meta
    if meta.storage == STORAGE_INT:
        if bool((self._data == 0).any()):
            raise ArithmeticError("0 has no multiplicative order.")
        n = meta.order - 1
        ops = _get_ops(self)
        ord_arr = torch.full(self._data.shape, n, dtype=torch.int64, device=self.device)
        for pi, ei in zip(*factors(n)):
            for _ in range(ei):
                cand = ord_arr // pi
                divides = ord_arr % pi == 0
                pw = ops.power(self._data, torch.where(divides, cand, 1), nbits=max(1, n.bit_length()))
                ord_arr = torch.where(divides & (pw == 1), cand, ord_arr)
        out = ord_arr.cpu().numpy()
        return out if out.ndim else np.int64(out)
    x = _storage_to_ints(meta, self._data)
    if (np.asarray(x) == 0).any():
        raise ArithmeticError("0 has no multiplicative order.")
    hf = get_host_field(meta)
    vals = [hf.multiplicative_order(int(v)) for v in np.asarray(x, dtype=object).reshape(-1)]
    dtype = np.int64 if meta.order - 1 <= np.iinfo(np.int64).max else object
    out = np.array(vals, dtype=dtype).reshape(np.asarray(x).shape)
    if out.ndim:
        return out
    return np.int64(out) if dtype is np.int64 else int(out)


# ----------------------------------------------------------------------
# Trace and norm
# ----------------------------------------------------------------------

@_attach(FieldArray, "field_trace")
def field_trace(self):
    """Tr(x) = sum_i x^(p^i), in the prime subfield. The trace is GF(p)-linear,
    so it is one dot product of the base-p digits, split on the array's
    device, with the traces of the basis elements x^i (host ints)."""
    meta = self._meta
    sub = type(self).prime_subfield
    if meta.degree == 1:
        return sub._view(self._data, self._dtype)
    p, m = meta.characteristic, meta.degree
    x = self._data.to(torch.int64)
    if meta.storage == STORAGE_INT:
        digs = []
        for _ in range(m):
            digs.append(x % p)
            x = x // p
    elif meta.storage == STORAGE_DIGITS:
        digs = list(x)
    else:  # GF(2^m) on planar limbs: the bits
        digs = [(x[i // 16] >> (i % 16)) & 1 for i in range(m)]
    acc = torch.zeros_like(digs[0])
    for d, c in zip(digs, _trace_vector(meta)):
        if c:
            acc = acc + mulmod(d, c, p)
    return sub._view((acc % p).to(sub._meta.torch_dtype))


@functools.lru_cache(maxsize=None)
def _trace_vector(meta):
    """Tr(x^i) for i < m, each in [0, p): the power sums of the roots of the
    irreducible polynomial f, by Newton's identities over GF(p) (Tr(1) = m),
    O(m^2) operations on small ints."""
    p, m = meta.characteristic, meta.degree
    f = list(meta.irreducible_coeffs)  # descending, monic: f[k] is the coefficient of x^(m - k)
    sums = [m % p]
    for k in range(1, m):
        acc = k * f[k]
        for j in range(1, k):
            acc += f[j] * sums[k - j]
        sums.append(-acc % p)
    return tuple(sums)


@_attach(FieldArray, "field_norm")
def field_norm(self):
    """N(x) = x^((q - 1) / (p - 1)), in the prime subfield: the field's power
    (kernel K8-A for GF(2^m), m <= 16), whose int repr is already below p."""
    meta = self._meta
    sub = type(self).prime_subfield
    if meta.degree == 1:
        return sub._view(self._data, self._dtype)
    norm = self ** ((meta.order - 1) // (meta.characteristic - 1))
    d = norm._data
    if meta.storage == STORAGE_DIGITS:
        d = d[0]  # the value lies in GF(p): digit 0
    elif meta.storage != STORAGE_INT:
        d = d[0].to(torch.int64) & 1  # GF(2): bit 0 of limb 0
    return sub._view(d.to(sub._meta.torch_dtype))


# ----------------------------------------------------------------------
# Matrix methods
# ----------------------------------------------------------------------

@_attach(FieldArray, "row_reduce")
def row_reduce(self, ncols=None, eye="left"):
    """Reduced row echelon form; ``eye`` other than "left" puts the identity
    at the right: the matrix is reversed along both axes, reduced, and
    reversed back (reference semantics)."""
    if eye != "left":
        if self.ndim != 2:
            raise ValueError(f"Argument 'A' must be 2-D, not {self.ndim}-D.")
        cls = type(self)

        def flip(t):  # through an int16 view: torch has no flip for uint16 limbs
            return _linalg._i16(t).flip((-2, -1)).view(t.dtype)

        R = _linalg.row_reduce(cls._view(flip(self._data), self._dtype), ncols=ncols)
        return cls._view(flip(R._data), self._dtype)
    return _linalg.row_reduce(self, ncols=ncols)


@_attach(FieldArray, "lu_decompose")
def lu_decompose(self):
    return _linalg.lu_decompose(self)


@_attach(FieldArray, "plu_decompose")
def plu_decompose(self):
    return _linalg.plu_decompose(self)


@_attach(FieldArray, "row_space")
def row_space(self):
    """Basis of the row space, as rows of a matrix
    (reference: src/galois/_fields/_array.py:1487-1547)."""
    if self.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {self.ndim}-D.")
    R = _linalg.row_reduce(self)
    return R[: _nonzero_row_count(R)]


@_attach(FieldArray, "column_space")
def column_space(self):
    return row_space(self.T)


@_attach(FieldArray, "left_null_space")
def left_null_space(self):
    """Basis for {x : xA = 0} (reference: src/galois/_fields/_array.py:1604):
    the rows of RREF([A | I]) whose A part vanished, reduced again."""
    A = self
    if A.ndim != 2:
        raise ValueError(f"Argument 'A' must be 2-D, not {A.ndim}-D.")
    cls = type(A)
    m, n = A.shape
    I = cls.Identity(m, device=A.device)
    AI = cls._view(torch.cat([A._data, I._data], dim=-1), A._dtype)
    R = _linalg.row_reduce(AI, ncols=n)
    rank = _nonzero_row_count(R[:, :n])
    LN = R[rank:, n:] if rank < m else cls.Zeros((0, m), device=A.device)
    if LN.shape[0] > 0:
        LN = _linalg.row_reduce(LN)
    return LN


@_attach(FieldArray, "null_space")
def null_space(self):
    return left_null_space(self.T)


def _nonzero_row_count(R) -> int:
    """1 + the index of the last row of R with a nonzero, counted on R's
    device; one read-back."""
    if R.size == 0:
        return 0
    nz = torch.logical_not(_get_ops(R).is_zero(R._data)).any(dim=-1)
    return int((nz * torch.arange(1, nz.numel() + 1, device=nz.device)).max())


# ----------------------------------------------------------------------
# Element and matrix polynomials
# ----------------------------------------------------------------------

@_attach(FieldArray, "characteristic_poly")
def characteristic_poly(self):
    """Of a 0-D element: prod (x - x^(p^i)) over its conjugates; of a square
    matrix: det(xI - A) (reference: src/galois/_fields/_array.py:1845-1978)."""
    if self.ndim == 0:
        return _element_char_poly(self, minimal=False)
    if self.ndim == 2 and self.shape[0] == self.shape[1]:
        return _matrix_char_poly(self)
    raise ValueError(f"The array must be 0-D or a square 2-D matrix, not shape {self.shape}.")


@_attach(FieldArray, "minimal_poly")
def minimal_poly(self):
    """Of a 0-D element: prod (x - c) over its distinct conjugates; of a
    square matrix: the monic annihilator of least degree."""
    if self.ndim == 0:
        return _element_char_poly(self, minimal=True)
    if self.ndim == 2 and self.shape[0] == self.shape[1]:
        return _matrix_minimal_poly(self)
    raise ValueError(f"The array must be 0-D or a square 2-D matrix, not shape {self.shape}.")


def _element_char_poly(x, minimal: bool):
    from ..polys import _hostpoly as hp
    from ..polys._poly import Poly

    meta = x._meta
    hf = get_host_field(meta)
    conjugates = []
    cur = int(x)
    for _ in range(meta.degree):
        if minimal and cur in conjugates:
            break
        conjugates.append(cur)
        cur = hf.power(cur, meta.characteristic)
    poly = [1]
    for c in conjugates:
        poly = hp.mul(hf, poly, [hf.negative(c), 1])
    # the coefficients lie in GF(p): a Poly over the prime subfield
    return Poly(poly[::-1], field=type(x).prime_subfield)


def _matrix_char_poly(A):
    """Characteristic polynomial of a square matrix: on the matrix's device
    from n = 32 for int storage (Hessenberg and the minor recurrence,
    ops/_charpoly.py), else the division-free host Berkowitz loop, as the
    JAX package routes it."""
    from ..ops import _charpoly
    from ..polys._poly import Poly

    cls = type(A)
    n = A.shape[0]
    if _charpoly.supports(cls._meta) and n >= 32 and cls._mode != "python-calculate":
        coeffs_asc = _charpoly.charpoly_data(cls._meta, kernel_mode(cls), A._data)
        return Poly(cls._view(coeffs_asc.flip(0), A._dtype))

    hf = get_host_field(cls._meta)
    M = [[int(v) for v in row] for row in np.asarray(A, dtype=object)]
    # Berkowitz: C starts as the char poly of the 1x1 leading principal
    # submatrix, and each step multiplies by a Toeplitz matrix.
    C = [1, hf.negative(M[0][0])]  # descending coeffs
    for k in range(1, n):
        # R = row (M[k][0..k-1]), Cc = column (M[0..k-1][k]), B = leading k x k;
        # t_0 = 1, t_1 = -M[k][k], t_j = -(R @ B^(j-2) @ Cc) for j >= 2
        R = M[k][:k]
        vec = [M[i][k] for i in range(k)]
        B = [row[:k] for row in M[:k]]
        t = [1, hf.negative(M[k][k])]
        for j in range(2, k + 2):
            dot = 0
            for i in range(k):
                dot = hf.add(dot, hf.multiply(R[i], vec[i]))
            t.append(hf.negative(dot))
            if j < k + 1:
                vec = [
                    functools.reduce(hf.add, (hf.multiply(B[i][l], vec[l]) for l in range(k)), 0)
                    for i in range(k)
                ]
        newC = [0] * (k + 2)
        for i, tv in enumerate(t):
            if tv == 0:
                continue
            for j, cv in enumerate(C):
                if i + j < len(newC):
                    newC[i + j] = hf.add(newC[i + j], hf.multiply(tv, cv))
        C = newC
    return Poly(C, field=cls)


def _matrix_minimal_poly(A):
    """Minimal polynomial of a square matrix. Above n^2 = 1024, for int
    storage, on the matrix's device: the Krylov minimal polynomials of up to
    four vectors drawn from np.random.default_rng(0x5EED) (the JAX package's
    draws), lcm'd, until the lcm has degree n or m(A) == 0 (checked on the
    device); otherwise, and if that fails, the dependence of I, A, A^2, ...
    solved exactly on the host."""
    from .._polymorphic import lcm as poly_lcm
    from ..ops import _minpoly
    from ..polys._poly import Poly

    cls = type(A)
    n = A.shape[0]
    ops = _get_ops(cls)
    if _minpoly.supports(cls._meta) and n * n > 1024 and cls._mode != "python-calculate":
        rng = np.random.default_rng(0x5EED)
        m_poly = None
        for _ in range(4):
            v = cls(rng.integers(0, min(cls.order, 2**62), size=n, dtype=np.int64) % cls.order, device=A.device)
            coeffs, d = _minpoly.krylov_minpoly_data(cls._meta, kernel_mode(cls), A._data, v._data)
            d = int(d)
            cand = Poly(cls._view(coeffs[: d + 1].flip(0), A._dtype))
            m_poly = cand if m_poly is None else poly_lcm(m_poly, cand)
            if m_poly.degree >= n or bool(ops.is_zero(m_poly(A, elementwise=False)._data).all()):
                return m_poly
        # the candidates did not annihilate A (a degenerate draw over a tiny field)

    hf = get_host_field(cls._meta)
    powers = [cls.Identity(n, device=A.device)]
    for _ in range(n):
        powers.append(_linalg.matmul(powers[-1], A))
    flat = [np.asarray(P, dtype=object).reshape(-1) for P in powers]
    for d in range(1, n + 1):
        # solve sum_{i<d} c_i A^i = -A^d
        Mat = np.stack(flat[:d], axis=1)  # (n^2, d)
        rhs = np.array([hf.negative(int(v)) for v in flat[d]], dtype=object)
        sol = _solve_overdetermined(cls, Mat, rhs)
        if sol is not None:
            return Poly([1] + [int(c) for c in sol[::-1]], field=cls)
    raise RuntimeError("unreachable: the characteristic polynomial annihilates A")


def _solve_overdetermined(cls, Mat, rhs):
    """Mat @ c = rhs solved exactly on the host, the free variables 0, or None
    if the system is inconsistent: a row of RREF([Mat | rhs]) at or below the
    rank that is nonzero in the rhs column alone."""
    d = Mat.shape[1]
    R, rank, pivots = _linalg._host_row_reduce(cls, np.concatenate([Mat, rhs[:, None]], axis=1), d)
    if any(R[rank:, d]):
        return None
    sol = [0] * d
    for i, c in enumerate(pivots):
        sol[c] = int(R[i, d])
    return sol


# ----------------------------------------------------------------------
# Roots of unity
# ----------------------------------------------------------------------

@_attach(FieldArrayMeta, "primitive_root_of_unity")
def primitive_root_of_unity(cls, n: int):
    """omega = alpha^((q - 1) / n) (reference: src/galois/_fields/_array.py:1126)."""
    n = int(n)
    q = cls.order
    if not 1 <= n < q:
        raise ValueError(f"Argument 'n' must be in [1, {q}), not {n}.")
    if (q - 1) % n != 0:
        raise ValueError(f"There are no primitive {n}-th roots of unity in {cls.name}.")
    return cls(get_host_field(cls._meta).power(cls._meta.primitive_element_int, (q - 1) // n))


@_attach(FieldArrayMeta, "primitive_roots_of_unity")
def primitive_roots_of_unity(cls, n: int):
    n = int(n)
    q = cls.order
    if (q - 1) % n != 0:
        raise ValueError(f"There are no primitive {n}-th roots of unity in {cls.name}.")
    hf = get_host_field(cls._meta)
    base = hf.power(cls._meta.primitive_element_int, (q - 1) // n)
    return cls(sorted(hf.power(base, k) for k in totatives(n)))


# ----------------------------------------------------------------------
# Display tables, on host ints (the JAX package's strings, character for
# character)
# ----------------------------------------------------------------------

def _table(header, rows) -> str:
    widths = [max(len(h), max(len(r[j]) for r in rows)) for j, h in enumerate(header)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "|" + "|".join(f" {h:^{w}} " for h, w in zip(header, widths)) + "|", sep]
    for r in rows:
        out.append("|" + "|".join(f" {v:^{w}} " for v, w in zip(r, widths)) + "|")
        out.append(sep)
    return "\n".join(out)


@_attach(FieldArrayMeta, "repr_table")
def repr_table(cls, element=None, sort: str = "power") -> str:
    """The power, polynomial, vector and integer reprs of every element, by
    the powers of ``element`` (the primitive element unless given), sorted
    by power or by int repr."""
    from ..ops._dlog import host_log
    from ..polys._conversions import integer_to_poly, poly_to_str

    if sort not in ("power", "int"):
        raise ValueError(f"Argument 'sort' must be 'power' or 'int', not {sort!r}.")
    q, p = cls.order, cls.characteristic
    hf = get_host_field(cls._meta)
    alpha = cls._meta.primitive_element_int if element is None else int(cls(element, device="cpu"))
    if sort == "power":
        elems, cur = [], 1
        for i in range(q - 1):
            elems.append((i, cur))
            cur = hf.multiply(cur, alpha)
    else:
        elems = [(host_log(cls._meta, e, alpha), e) for e in range(1, q)]
    rows = [("0", "0", str([0] * cls.degree), "0")]
    for i, e in elems:
        power = "1" if i == 0 else ("α" if i == 1 else f"α^{i}")
        rows.append((power, poly_to_str(integer_to_poly(e, p), poly_var="α"), str(integer_to_poly(e, p, cls.degree - 1)), str(e)))
    return _table(("Power", "Polynomial", "Vector", "Integer"), rows)


@_attach(FieldArrayMeta, "arithmetic_table")
def arithmetic_table(cls, operation: str, x=None, y=None) -> str:
    """The table of x op y for op in '+', '-', '*', '/', over every element
    (nonzero divisors for '/') unless x or y is given, in the class's
    element repr."""
    if operation not in ("+", "-", "*", "/"):
        raise ValueError(f"Argument 'operation' must be in ['+', '-', '*', '/'], not {operation!r}.")
    hf = get_host_field(cls._meta)
    opfn = {"+": hf.add, "-": hf.subtract, "*": hf.multiply, "/": hf.divide}[operation]

    def given(v):
        return [int(e) for e in np.asarray(cls(v, device="cpu"), dtype=object).reshape(-1)]

    xs = given(x) if x is not None else list(range(cls.order))
    ys = given(y) if y is not None else list(range(1 if operation == "/" else 0, cls.order))
    fmt = cls._element_to_str
    rows = [[fmt(xv)] + [fmt(opfn(xv, yv)) for yv in ys] for xv in xs]
    return _table([f"x {operation} y"] + [fmt(v) for v in ys], rows)
