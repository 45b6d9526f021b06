"""FieldMeta: the static field descriptor.

The port's counterpart of ``galois_tpu/fields/_meta.py``. It keeps the field
parameters, the device storage format and the host constants built from
them. Only int storage (one integer per element) is ported: GF(p) with
p <= 2^32, GF(2^m) with m <= 32 and GF(p^m), p odd, with p^m <= 2^31. The
digit and limb storage kinds of the JAX package are still to be ported.

Storage dtypes follow torch's integer support: ``torch.uint8`` for order
<= 2^8, else ``torch.int64``. torch's ``uint16``/``uint32`` lack ``+``,
``>>``, ``%`` and ``<``, so the JAX package's u16/u32 storage does not carry
over. ``internal_dtype`` stays the JAX package's NumPy dtype: it is what
``np.asarray`` of an array returns.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..polys._conversions import integer_to_poly

# External dtypes permitted for the user-facing representation (the JAX
# package's master list).
DTYPES = [np.uint8, np.uint16, np.uint32, np.int8, np.int16, np.int32, np.int64]

# Fields at or below this order have a lookup-table mode (the reference's
# auto rule, src/galois/_domains/_meta.py:39-48).
LOOKUP_TABLE_MAX_ORDER = 2**20

STORAGE_INT = "int"  # one integer per element


class FieldMeta:
    """Immutable descriptor of a finite field GF(p^m) plus device-layout info.

    Hash/equality are defined by (p, m, irreducible_poly_int,
    primitive_element_int) so descriptors can key kernel and plan caches.
    """

    def __init__(
        self,
        characteristic: int,
        degree: int,
        irreducible_poly_int: int,
        primitive_element_int: int,
    ):
        p, m = int(characteristic), int(degree)
        self.characteristic = p
        self.degree = m
        self.order = p**m
        self.irreducible_poly_int = int(irreducible_poly_int)
        self.primitive_element_int = int(primitive_element_int)

        self.is_prime_field = m == 1
        self.is_extension_field = m > 1

        q = self.order
        int_storage = q <= 2**32 if m == 1 else (m <= 32 if p == 2 else q <= 2**31)
        if not int_storage:
            raise NotImplementedError(
                f"GF({p}^{m}) needs digit or limb storage, which the torch port does not "
                "have yet (ROADMAP.md, queue 1 item 6)."
            )
        self.storage = STORAGE_INT
        self.internal_dtype = np.uint32 if q > 2**16 else (np.uint16 if q > 2**8 else np.uint8)
        self.torch_dtype = torch.uint8 if q <= 2**8 else torch.int64

        # Valid external dtypes are those that can hold order-1.
        self.dtypes = [d for d in DTYPES if np.iinfo(d).max >= q - 1]
        self.default_ufunc_mode = "jit-calculate"
        # GF(2) has no lookup mode: its bitwise ops are already optimal.
        self.ufunc_modes = (
            ["jit-lookup", "jit-calculate", "python-calculate"]
            if 2 < q <= LOOKUP_TABLE_MAX_ORDER
            else ["jit-calculate", "python-calculate"]
        )

        self._key = (p, m, self.irreducible_poly_int, self.primitive_element_int)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, FieldMeta) and self._key == other._key

    def __repr__(self):
        return f"FieldMeta(GF({self.characteristic}^{self.degree}))"

    @property
    def name(self) -> str:
        if self.degree == 1:
            return f"GF({self.characteristic})"
        return f"GF({self.characteristic}^{self.degree})"

    @functools.cached_property
    def irreducible_coeffs(self) -> Tuple[int, ...]:
        """Coefficients of the irreducible polynomial, descending degrees."""
        return tuple(integer_to_poly(self.irreducible_poly_int, self.characteristic, self.degree))

    @functools.cached_property
    def reduction_matrix(self) -> np.ndarray:
        """(m-1, m) matrix R with R[i] = coeffs of x^(m+i) mod f(x), ascending.

        Reduces a 2m-1 coefficient product: out = low + high @ R (mod p),
        where high[i] is the coefficient of x^(m+i)."""
        p, m = self.characteristic, self.degree
        if m <= 1:
            return np.zeros((0, 1), dtype=np.int64)
        f = list(self.irreducible_coeffs)  # descending, monic, length m+1
        cur = [(-c) % p for c in f[1:][::-1]]  # ascending coeffs of x^m mod f
        rows = [cur[:]]
        for _ in range(m - 2):
            # multiply by x: shift up, then fold the overflow coefficient
            hi = cur[-1]
            cur = [0] + cur[:-1]
            cur = [(c + hi * rows[0][j]) % p for j, c in enumerate(cur)]
            rows.append(cur[:])
        return np.array(rows, dtype=np.int64)

    def int_to_digits(self, x: int) -> List[int]:
        """Int repr -> base-p digits ascending, length m."""
        p, m = self.characteristic, self.degree
        return [(x // p**i) % p for i in range(m)]

    def digits_to_int(self, digits) -> int:
        p = self.characteristic
        return sum(int(d) * p**i for i, d in enumerate(digits))
