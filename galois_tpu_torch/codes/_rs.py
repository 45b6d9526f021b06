"""Reed-Solomon codes.

Port of ``galois_tpu/codes/_rs.py`` (reference:
src/galois/_codes/_reed_solomon.py:23-1113). RS over GF(q) directly: the
syndrome field equals the symbol field, so the shared batched decoder
(``codes/_decoder.py``) runs with extension = field, on the codewords'
device; over GF(2^8) its field products are kernel K8."""

from __future__ import annotations

from typing import Optional, Type

import numpy as np

from .._tracing import span
from ..fields import GF
from ..fields._array import FieldArray
from ..nt import ilog
from ..polys._poly import Poly
from ..polys._primitive import matlab_primitive_poly
from ._cyclic import _CyclicCode
from ..ops._kernels import kernel_mode
from ._decoder import make_decoder

__all__ = ["ReedSolomon"]


class ReedSolomon(_CyclicCode):
    """An RS(n, k) code over GF(q) with n | q - 1."""

    def __init__(
        self,
        n: int,
        k: Optional[int] = None,
        d: Optional[int] = None,
        field: Optional[Type[FieldArray]] = None,
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
        if field is not None and not (isinstance(field, type) and issubclass(field, FieldArray)):
            raise TypeError(
                f"Argument 'field' must be a FieldArray subclass, not {field!r}."
            )
        n = int(n)
        # Reference parity: c >= 0 and any d >= 1 (k == n is the valid d = 1
        # code) — reference: _reed_solomon.py:175-178.
        if c < 0:
            raise ValueError(f"Argument 'c' must be at least 0, not {c}.")
        if d is not None and d < 1:
            raise ValueError(f"Argument 'd' must be at least 1, not {d}.")
        if k is not None and not 1 <= k <= n:
            raise ValueError(f"Argument 'k' must satisfy 1 <= k <= n = {n}, not {k}.")

        if field is None:
            q = 2
            m = ilog(n, q) + 1
            irreducible_poly = matlab_primitive_poly(q, m)
            field = GF(q**m, irreducible_poly=int(irreducible_poly))

        if alpha is None:
            alpha = field.primitive_root_of_unity(n)
        else:
            alpha = field(alpha)

        # Singleton bound: d = n - k + 1 (reference: _reed_solomon.py:195-206)
        if d is not None and k is not None:
            if d != n - k + 1:
                raise ValueError(
                    "Arguments 'k' and 'd' are inconsistent: Reed-Solomon codes have d = n - k + 1."
                )
        elif d is not None:
            k = n - (d - 1)
        elif k is not None:
            d = (n - k) + 1
        else:
            raise ValueError("Argument 'k' or 'd' must be provided to define the code size.")

        roots = alpha ** (int(c) + np.arange(0, d - 1))
        generator_poly = Poly.Roots(roots)

        self._alpha = alpha
        self._alpha_int = int(alpha)  # read once: a decode reads nothing back before its counts
        self._c = int(c)
        self._roots = roots
        self._is_primitive = n == field.order - 1
        self._is_narrow_sense = c == 1

        super().__init__(n, k, d, generator_poly, systematic)

        # Vandermonde-style H (reference: _reed_solomon.py:220)
        from ..fields._hostfield import get_host_field

        hf = get_host_field(field._meta)
        H = np.zeros((d - 1, n), dtype=object)
        rints = [int(v) for v in np.asarray(roots, dtype=object)] if d > 1 else []
        for i, r in enumerate(rints):
            for j, e in enumerate(range(n - 1, -1, -1)):
                H[i, j] = hf.power(r, e)
        self._H = field(H) if d > 1 else field.Zeros((0, n))

    # ------------------------------------------------------------------
    def _decode_codeword(self, codeword, erasures=None):
        field = self.field
        if self.d <= 1:
            return codeword, np.zeros(codeword.shape[0], dtype=np.int64)
        decoder = make_decoder(
            field._meta,
            kernel_mode(field),
            field.order,
            codeword.shape[-1],
            self.n,
            self.d,
            self.c,
            self._alpha_int,
            with_erasures=erasures is not None,
        )
        out, n_errors = decoder(codeword._data, erasures)
        with span("gf.decode.readback", n_errors):
            n_errors = n_errors.cpu().numpy()
        return field._view(out), n_errors

    # ------------------------------------------------------------------
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
        return f"<Reed-Solomon Code: [{self.n}, {self.k}, {self.d}] over {self.field.name}>"

    def __str__(self) -> str:
        lines = [
            "Reed-Solomon Code:",
            f"  [n, k, d]: [{self.n}, {self.k}, {self.d}]",
            f"  field: {self.field.name}",
            f"  generator_poly: {self.generator_poly}",
            f"  is_primitive: {self.is_primitive}",
            f"  is_narrow_sense: {self.is_narrow_sense}",
            f"  is_systematic: {self.is_systematic}",
        ]
        return "\n".join(lines)
