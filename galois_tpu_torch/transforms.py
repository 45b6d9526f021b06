"""Public NTT API, as ``galois_tpu/transforms.py``.

The JAX package's contract: ``size`` defaults to ``len(x)`` and the
transform runs along the trailing axis, so ``ntt`` is for 1-D input;
batched transforms are ``np.fft.fft``/``np.fft.ifft``. A FieldArray over
GF(modulus) is transformed where it lies, on its device; other input is
converted on the host and placed on the package's default device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .fields import GF
from .fields._array import FieldArray
from .nt import is_prime
from .ops._ntt import field_fft, field_ifft

__all__ = ["ntt", "intt"]


def ntt(x, size: Optional[int] = None, modulus: Optional[int] = None) -> FieldArray:
    """Number-theoretic transform of x over GF(modulus)."""
    if isinstance(x, FieldArray) and not type(x).is_prime_field:
        raise ValueError(f"If argument 'x' is a FieldArray, it must be over a prime field, not {type(x).name}.")
    if modulus is None and isinstance(x, FieldArray):
        modulus = type(x).characteristic
    return _ntt(x, size=size, modulus=modulus, forward=True)


def intt(
    X, size: Optional[int] = None, modulus: Optional[int] = None, scaled: bool = True
) -> FieldArray:
    """Inverse number-theoretic transform."""
    if isinstance(X, FieldArray) and not type(X).is_prime_field:
        raise ValueError(f"If argument 'X' is a FieldArray, it must be over a prime field, not {type(X).name}.")
    if modulus is None and isinstance(X, FieldArray):
        modulus = type(X).characteristic
    return _ntt(X, size=size, modulus=modulus, forward=False, scaled=scaled)


def _ntt(x, size=None, modulus=None, forward=True, scaled=True):
    if isinstance(x, FieldArray) and modulus == type(x).characteristic:
        xf, length = x, len(x)
    else:
        arr = np.asarray(x)
        xf, length = None, len(arr)
    if size is None:
        size = length
    if modulus is None:
        # The smallest prime p = m*size + 1 with p > max(x).
        m = max(1, int(np.ceil(int(np.max(arr)) / size)))
        while not is_prime(m * size + 1):
            m += 1
        modulus = m * size + 1

    if size < length:
        raise ValueError(f"Argument 'size' must be at least the input length {length}, not {size}.")
    if not is_prime(modulus):
        raise ValueError(f"Argument 'modulus' must be prime, {modulus} is not.")
    if (modulus - 1) % size != 0:
        raise ValueError("Argument 'modulus' must equal m * size + 1 for the transform size.")
    if xf is None:
        if not modulus > int(np.max(arr)):
            raise ValueError(f"Argument 'modulus' must exceed the max input value {int(np.max(arr))}.")
        xf = GF(modulus)(arr, device=x.device if isinstance(x, FieldArray) else None)

    if forward:
        return field_fft(xf, n=size)
    return field_ifft(xf, n=size, norm="backward" if scaled else "forward")
