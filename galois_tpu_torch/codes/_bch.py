"""BCH codes.

Port of ``galois_tpu/codes/_bch.py`` (reference:
src/galois/_codes/_bch.py:27-1252). General (not just binary or
narrow-sense) BCH over a prime field GF(q) with syndrome arithmetic in
GF(q^m). Construction is host-side (products of minimal polynomials);
encode is a field matmul; decode is the batched branch-free pipeline of
``codes/_decoder.py`` on the codewords' device, whose products in GF(2^9)
(BCH(511, k)) are kernel K7 and in GF(2^m), m <= 8, kernel K8.
"""

from __future__ import annotations

from typing import Optional, Type

import numpy as np
import torch

from .._tracing import span
from ..fields import GF, GF2
from ..fields._array import FieldArray
from ..nt import ilog
from ..polys._poly import Poly
from ..polys._primitive import matlab_primitive_poly
from ._cyclic import _CyclicCode
from ..ops._kernels import kernel_mode
from ._decoder import make_decoder

__all__ = ["BCH"]


class BCH(_CyclicCode):
    """A general BCH(n, k) code over GF(q) with syndromes in GF(q^m)."""

    def __init__(
        self,
        n: int,
        k: Optional[int] = None,
        d: Optional[int] = None,
        field: Optional[Type[FieldArray]] = None,
        extension_field: Optional[Type[FieldArray]] = None,
        alpha=None,
        c: int = 1,
        systematic: bool = True,
    ):
        if not isinstance(n, (int, np.integer)):
            raise TypeError(f"Argument 'n' must be an integer, not {type(n).__name__}.")
        if k is not None and not isinstance(k, (int, np.integer)):
            raise TypeError(f"Argument 'k' must be an integer, not {type(k).__name__}.")
        if d is not None and not isinstance(d, (int, np.integer)):
            raise TypeError(f"Argument 'd' must be an integer, not {type(d).__name__}.")
        if not isinstance(c, (int, np.integer)):
            raise TypeError(f"Argument 'c' must be an integer, not {type(c).__name__}.")
        if not isinstance(systematic, bool):
            raise TypeError(
                f"Argument 'systematic' must be a bool, not {type(systematic).__name__}."
            )
        for name, f in (("field", field), ("extension_field", extension_field)):
            if f is not None and not (isinstance(f, type) and issubclass(f, FieldArray)):
                raise TypeError(
                    f"Argument {name!r} must be a FieldArray subclass, not {f!r}."
                )
        n = int(n)
        if d is not None and d < 1:
            raise ValueError(f"Argument 'd' must be at least 1, not {d}.")
        if c < 0:
            raise ValueError(f"Argument 'c' must be at least 0, not {c}.")

        if field is None:
            field = GF2
        if not field.is_prime_field:
            raise ValueError(
                "BCH codes over GF(q) for prime power q are not supported."
            )
        q = field.order

        if extension_field is None:
            m = ilog(n, q) + 1
            irreducible_poly = matlab_primitive_poly(q, m)
            extension_field = GF(q**m, irreducible_poly=int(irreducible_poly))

        if alpha is None:
            alpha = extension_field.primitive_root_of_unity(n)
        else:
            alpha = extension_field(alpha)

        if d is not None:
            generator_poly, roots = _generator_poly_from_d(d, field, alpha, c)
            kk = n - generator_poly.degree
            if k not in (None, kk):
                raise ValueError(
                    f"The requested [{n}, {k}, {d}] code is not consistent; design "
                    f"distance {d} gives a [{n}, {kk}, {d}] code."
                )
            k = kk
        elif k is not None:
            generator_poly, roots = _generator_poly_from_k(n, k, field, extension_field, alpha, c)
            d = roots.size + 1
        else:
            raise ValueError("Argument 'k' or 'd' must be provided to define the code size.")

        self._extension_field = extension_field
        self._alpha = alpha
        self._alpha_int = int(alpha)  # read once: a decode reads nothing back before its counts
        self._c = int(c)
        self._roots = roots
        self._is_primitive = n == extension_field.order - 1
        self._is_narrow_sense = c == 1

        super().__init__(n, k, d, generator_poly, systematic)

    # ------------------------------------------------------------------
    def _decode_codeword(self, codeword, erasures=None):
        ext = self.extension_field
        if self.d <= 1:
            return codeword, np.zeros(codeword.shape[0], dtype=np.int64)
        decoder = make_decoder(
            ext._meta,
            kernel_mode(ext),
            self.field.order,
            codeword.shape[-1],
            self.n,  # design_n: Chien scans the full parent-code length even
            # when decoding a shortened (ns < n) codeword — error locators
            # index positions of the parent code (reference feeds self.n,
            # src/galois/_codes/_bch.py:726)
            self.d,
            self.c,
            self._alpha_int,
            with_erasures=erasures is not None,
        )
        out, n_errors = decoder(codeword._data, erasures)
        out = (out.to(torch.int64) % self.field.order).to(self.field._meta.torch_dtype)
        with span("gf.decode.readback", n_errors):
            n_errors = n_errors.cpu().numpy()
        return self.field._view(out), n_errors

    # ------------------------------------------------------------------
    @property
    def extension_field(self):
        return self._extension_field

    @property
    def alpha(self):
        return self._alpha

    @property
    def c(self) -> int:
        return self._c

    @property
    def roots(self):
        return self._roots

    @property
    def is_primitive(self) -> bool:
        return self._is_primitive

    @property
    def is_narrow_sense(self) -> bool:
        return self._is_narrow_sense

    def __repr__(self) -> str:
        return f"<BCH Code: [{self.n}, {self.k}, {self.d}] over {self.field.name}>"

    def __str__(self) -> str:
        lines = [
            "BCH Code:",
            f"  [n, k, d]: [{self.n}, {self.k}, {self.d}]",
            f"  field: {self.field.name}",
            f"  extension_field: {self.extension_field.name}",
            f"  generator_poly: {self.generator_poly}",
            f"  is_primitive: {self.is_primitive}",
            f"  is_narrow_sense: {self.is_narrow_sense}",
            f"  is_systematic: {self.is_systematic}",
        ]
        return "\n".join(lines)


def _absorb_root(field, alpha, c, j, q, ord_a, covered, g):
    """Incorporate the root alpha^(c+j) into g(x).

    If its exponent lies in an already-covered q-ary cyclotomic coset mod
    ord(alpha), its minimal polynomial already divides g and nothing
    changes; otherwise the coset is marked covered and g is multiplied by
    the root's minimal polynomial. Returns (g, added_degree).
    """
    e = (int(c) + j) % ord_a
    if e in covered:
        return g, 0
    covered.add(e)
    x = e * q % ord_a
    while x != e:
        covered.add(x)
        x = x * q % ord_a
    mp = (alpha ** (int(c) + j)).minimal_poly()
    return g * Poly(mp.coefficients(), field=field), mp.degree


def _generator_poly_from_d(d, field, alpha, c):
    """g(x) for design distance d: the product of the minimal polynomials
    of alpha^c .. alpha^(c+d-2), taking each q-ary cyclotomic coset once
    (equals the reference's LCM-of-distinct-minimal-polys,
    src/galois/_codes/_bch.py:1178-1197, since minimal polys of conjugate
    roots coincide and distinct ones are coprime)."""
    q = field.order
    ord_a = int(alpha.multiplicative_order())
    covered: set = set()
    g = Poly.One(field)
    for j in range(d - 1):
        g, _ = _absorb_root(field, alpha, c, j, q, ord_a, covered, g)
    roots = alpha ** (int(c) + np.arange(0, d - 1))
    return g, roots


def _generator_poly_from_k(n, k, field, extension_field, alpha, c):
    """g(x) for dimension k: walk the consecutive-root ladder once.

    deg g is non-decreasing in the root count, stepping by a coset size
    whenever a root opens a new conjugacy class, so one incremental pass
    finds every root count whose degree equals n - k; the last one before
    the degree steps past n - k maximizes the design distance. (Same
    result as the reference's bisection-plus-increment over d,
    src/galois/_codes/_bch.py:1200-1252, computed without re-deriving
    minimal polynomials at each probe.)"""
    target = n - k
    q = field.order
    ord_a = int(alpha.multiplicative_order())
    covered: set = set()
    g = Poly.One(field)
    degree = 0
    hit = None  # (g, root_count) at the largest root count with degree == target
    j = 0
    while j <= ord_a:
        if degree == target:
            hit = (g, j)
        elif degree > target:
            break
        if j == ord_a:
            break
        g, added = _absorb_root(field, alpha, c, j, q, ord_a, covered, g)
        degree += added
        j += 1
    if hit is None:
        raise ValueError(
            f"The BCH({n}, {k}) code over {field.name} with alpha={int(alpha)} and c={c} does not exist."
        )
    g, n_roots = hit
    roots = alpha ** (int(c) + np.arange(0, n_roots))
    return g, roots
