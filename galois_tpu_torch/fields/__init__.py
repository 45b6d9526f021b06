"""Finite-field arrays of the torch port: the GF() factory and FieldArray."""

from . import _methods  # noqa: F401  (attaches the element and root-of-unity methods)
from ._array import FieldArray, FieldArrayMeta
from ._factory import GF, Field
from ._meta import FieldMeta

GF2 = GF(2)

__all__ = ["GF", "Field", "FieldArray", "FieldArrayMeta", "FieldMeta", "GF2"]
