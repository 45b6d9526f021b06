"""FieldMeta: the static field descriptor.

The port's counterpart of ``galois_tpu/fields/_meta.py``. It keeps the field
parameters, the device storage format and the host constants built from
them. Three storage kinds, as in the JAX package:

- int storage, one integer per element: GF(p) with p <= 2^32, GF(2^m) with
  m <= 32 and GF(p^m), p odd, with p^m <= 2^31. Its dtypes follow torch's
  integer support: ``torch.uint8`` for order <= 2^8, else ``torch.int64``
  (torch's ``uint16``/``uint32`` lack ``+``, ``>>``, ``%`` and ``<``, so the
  JAX package's u16/u32 int storage does not carry over);
- limb storage, GF(p) with p > 2^32: L little-endian base-2^16 limbs per
  element in ``torch.uint16``, PLANAR, with the limb axis leading, shape
  (L, *shape), exactly the JAX package's layout. The arithmetic widens the
  limbs to int64 (``ops/_kernels.py``); the Goldilocks multiply kernel K10
  reads the planes as they are, 8 bytes per element;
- digit storage, GF(p^m) with p odd, m > 1 and p^m > 2^31: the m base-p
  digits of each element, ascending, in ``torch.int64`` (the JAX package's
  u32, so p < 2^32; int64 is the port's storage above 2^8, and a digit
  product of p < 2^31.5 fits it, larger p split it in
  ``ops/_kernels.py::mulmod``).
  The digit axis LEADS, shape (m, *shape), like the limbs' (the JAX package
  keeps it trailing, for the TPU's MXU contractions). One convention for
  every multi-word kind gives each digit a contiguous plane on the card, and
  every composite written for planar storage (linear algebra, Poly, the
  LFSR scans) takes digit fields unchanged;
- limb storage of GF(2^m) with m > 32: the m coefficient bits in L =
  ceil(m / 16) little-endian uint16 limbs, planar like the prime limbs. Its
  product, square and powers are kernel K14 on the card
  (``ops/_limb_binary.py``).

``storage_first`` is True for all three planar kinds. ``internal_dtype``
stays the JAX package's NumPy dtype: with ``dtypes`` it decides what
``np.asarray`` of an array returns (object arrays of Python ints above
2^63).
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
STORAGE_DIGITS = "digits"  # (m, ...) planar base-p digits, digit axis leading
STORAGE_LIMBS = "limbs"  # (L, ...) planar base-2^16 limbs, limb axis leading

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS


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
        if (m == 1 and q > 2**32) or (p == 2 and m > 32):
            self.storage = STORAGE_LIMBS
            self.internal_dtype = np.uint16
            self.torch_dtype = torch.uint16
            self.storage_width = -(-(q - 1).bit_length() // LIMB_BITS)
        elif m > 1 and p > 2 and q > 2**31:
            self.storage = STORAGE_DIGITS
            self.internal_dtype = np.uint32
            self.torch_dtype = torch.int64
            self.storage_width = m
        else:
            self.storage = STORAGE_INT
            self.internal_dtype = np.uint32 if q > 2**16 else (np.uint16 if q > 2**8 else np.uint8)
            self.torch_dtype = torch.uint8 if q <= 2**8 else torch.int64
            self.storage_width = 0  # scalar storage, no storage axis
        # True when the storage axis leads: limbs and digits.
        self.storage_first = self.storage != STORAGE_INT

        # Valid external dtypes are those that can hold order-1.
        self.dtypes = [d for d in DTYPES if np.iinfo(d).max >= q - 1] or [np.object_]
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

    @functools.cached_property
    def limb_count(self) -> int:
        return self.storage_width if self.storage == STORAGE_LIMBS else 0

    @functools.cached_property
    def prime_limbs(self) -> np.ndarray:
        """p as base-2^16 limbs, little-endian, length limb_count."""
        return int_to_limbs(self.characteristic, self.limb_count)

    @functools.cached_property
    def barrett_mu_limbs(self) -> np.ndarray:
        """floor(4^(16*L) / p) as L + 1 limbs, for Barrett reduction."""
        L = self.limb_count
        return int_to_limbs((1 << (2 * LIMB_BITS * L)) // self.characteristic, L + 1)

    def int_to_digits(self, x: int) -> List[int]:
        """Int repr -> base-p digits ascending, length m."""
        p, m = self.characteristic, self.degree
        return [(x // p**i) % p for i in range(m)]

    def digits_to_int(self, digits) -> int:
        p = self.characteristic
        return sum(int(d) * p**i for i, d in enumerate(digits))


def int_to_limbs(x: int, count: int) -> np.ndarray:
    """Python int -> little-endian base-2^16 limb array (int64) of length `count`."""
    limbs = []
    for _ in range(count):
        limbs.append(x & (LIMB_BASE - 1))
        x >>= LIMB_BITS
    if x:
        raise OverflowError("integer does not fit in the requested limb count")
    return np.array(limbs, dtype=np.int64)


def limbs_to_int(limbs) -> int:
    x = 0
    for i, limb in enumerate(limbs):
        x |= int(limb) << (LIMB_BITS * i)
    return x
