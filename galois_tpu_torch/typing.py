"""Type aliases for the public API, as ``galois_tpu.typing`` with
``torch.Tensor`` in the place of ``jax.Array``."""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence, Union

import numpy as np
import torch

if TYPE_CHECKING:
    from .fields._array import FieldArray
    from .polys._poly import Poly

__all__ = ["ElementLike", "IterableLike", "ArrayLike", "ShapeLike", "DTypeLike", "PolyLike"]

# A scalar field element: an int (the integer representation), a str (the
# polynomial-string representation, e.g. "x^2 + 2x + 1"), or a 0-D array.
ElementLike = Union[int, str, "FieldArray"]

# A recursively-iterable collection of ElementLike.
IterableLike = Union[Sequence[ElementLike], Sequence["IterableLike"]]

# Anything convertible into a FieldArray.
ArrayLike = Union[ElementLike, IterableLike, np.ndarray, torch.Tensor, "FieldArray"]

# A NumPy-style shape.
ShapeLike = Union[int, Sequence[int]]

# A NumPy-style dtype for the external representation of field elements.
DTypeLike = Union[np.integer, int, str, np.dtype]

# Anything convertible into a Poly: int repr, poly string, coefficient array.
PolyLike = Union[int, str, ArrayLike, "Poly"]
