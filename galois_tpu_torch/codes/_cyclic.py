"""Cyclic code base class.

Port of ``galois_tpu/codes/_cyclic.py`` (reference:
src/galois/_codes/_cyclic.py:21-233): G and H built on the host from g(x) and
h(x), then moved to the default device as field arrays."""

from __future__ import annotations

import numpy as np

from ..polys import _hostpoly as hp
from ..polys._poly import Poly, _hf
from ._linear import _LinearCode


class _CyclicCode(_LinearCode):
    """An [n, k, d] cyclic code defined by a generator polynomial g(x)."""

    def __init__(self, n: int, k: int, d: int, generator_poly: Poly, systematic: bool):
        self._generator_poly = generator_poly
        field = generator_poly.field
        F = _hf(field)

        # h(x) = (x^n - 1) / g(x) (reference: _cyclic.py:45-49)
        xn1 = [F.negative(1)] + [0] * (n - 1) + [1]  # ascending
        h, r = hp.divmod_(F, xn1, generator_poly._asc())
        if hp.trim(r) != [0]:
            raise ValueError(
                f"The generator polynomial {generator_poly} must divide x^{n} - 1."
            )
        self._parity_check_poly = Poly._from_asc(h, field)

        G = _generator_matrix(generator_poly, n, k, systematic)
        H = _parity_check_matrix(self._parity_check_poly, n, k)
        super().__init__(n, k, d, G, H, systematic)

    @property
    def generator_poly(self) -> Poly:
        return self._generator_poly

    @property
    def parity_check_poly(self) -> Poly:
        return self._parity_check_poly

    def _convert_codeword_to_message(self, codeword, ks: int):
        if self.is_systematic:
            return codeword[:, :ks]
        # Non-systematic: m(x) = c(x) / g(x) (reference: _cyclic.py:129-148)
        from ..ops._poly_div import batched_floordiv

        return batched_floordiv(codeword, self.generator_poly, ks)


def _generator_matrix(g: Poly, n: int, k: int, systematic: bool):
    """Build G from g(x). Systematic: row i encodes e_i with parity
    -(x^(n-1-i) mod g) (shift-register construction, reference: _cyclic.py:198-226).
    Non-systematic: row i = coefficients of x^(k-1-i) g(x)."""
    field = g.field
    F = _hf(field)
    ga = g._asc()
    G = np.zeros((k, n), dtype=object)
    if systematic:
        # Shift-register construction (reference: _cyclic.py:198-226):
        # parity row i holds -(x^(n-1-i) mod g). Row k-1 is
        # x^(n-k) mod g = -(g - x^(n-k)); each row above is x * (row below)
        # reduced mod g — O(k(n-k)) field ops instead of k pow_mods.
        deg_g = n - k
        if deg_g == 0:
            # d = 1 trivial code: g(x) = 1, G = I_k, no parity columns
            for i in range(k):
                G[i, i] = 1
            return field(G)
        rem = [F.negative(c) for c in ga[:deg_g]]  # x^(n-k) mod g, ascending
        rows = [list(rem)]
        for _ in range(k - 1):
            hi = rem[-1]
            rem = [0] + rem[:-1]
            if hi:
                for jj in range(deg_g):
                    rem[jj] = F.subtract(rem[jj], F.multiply(hi, ga[jj]))
            rows.append(list(rem))
        for i in range(k):
            G[i, i] = 1
            rem_i = rows[k - 1 - i]
            for deg, coeff in enumerate(rem_i):
                if coeff:
                    G[i, n - 1 - deg] = F.negative(coeff)
    else:
        for i in range(k):
            # x^(k-1-i) * g(x): coeffs ascending shifted by k-1-i
            shift = k - 1 - i
            for deg, coeff in enumerate(ga):
                if coeff:
                    G[i, n - 1 - (deg + shift)] = coeff
    return field(G)


def _parity_check_matrix(h: Poly, n: int, k: int):
    """H from the reversed parity-check polynomial: row i is the reversed
    h(x) shifted right by i (reference: _cyclic.py:229-233)."""
    field = h.field
    ha = h._asc()  # ascending, degree k
    # Reference places the REVERSED h(x)'s descending coefficients along the
    # diagonals (reference: _cyclic.py:229-233): row i = [h_0, h_1, ..., h_k]
    # starting at column i.
    H = np.zeros((n - k, n), dtype=object)
    for i in range(n - k):
        for j in range(k + 1):
            H[i, i + j] = ha[j]
    return field(H)
