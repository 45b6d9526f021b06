"""Field methods that the linear codes need, attached to FieldArray.

Port of the parts of ``galois_tpu/fields/_array.py`` and
``galois_tpu/fields/_methods.py`` that ``ReedSolomon`` and ``BCH`` are built
from:

- ``FieldArray.multiplicative_order``: on the device for int storage, with
  the static factorization of q - 1; host ints for limb storage;
- ``minimal_poly`` and ``characteristic_poly`` of a 0-D element (the
  product of (x - c) over its conjugates c, on the host);
- ``primitive_root_of_unity`` and ``primitive_roots_of_unity`` of a field
  class.

The char/min polys of a square matrix (``ops/_charpoly.py``,
``ops/_minpoly.py``) are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nt import factors, totatives
from ._array import FieldArray, FieldArrayMeta, _get_ops, _storage_to_ints
from ._hostfield import get_host_field
from ._meta import STORAGE_INT

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
        ops = _get_ops(meta, type(self)._mode)
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


@_attach(FieldArray, "characteristic_poly")
def characteristic_poly(self):
    """Of a 0-D element: the product of (x - x^(p^i)), i < m, over GF(p)."""
    return _element_char_poly(self, minimal=False)


@_attach(FieldArray, "minimal_poly")
def minimal_poly(self):
    """Of a 0-D element: the product of (x - c) over its distinct conjugates."""
    return _element_char_poly(self, minimal=True)


def _element_char_poly(x, minimal: bool):
    from ..polys import _hostpoly as hp
    from ..polys._poly import Poly

    if x.ndim != 0:
        raise NotImplementedError(
            "The characteristic and minimal polynomials of a matrix need ops/_charpoly.py and "
            "ops/_minpoly.py, which the torch port does not have yet."
        )
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
