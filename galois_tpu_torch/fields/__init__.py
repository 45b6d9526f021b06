"""Finite-field arrays of the torch port: the GF() factory and FieldArray."""

from ._array import FieldArray, FieldArrayMeta
from ._factory import GF, Field
from ._meta import FieldMeta

GF2 = GF(2)

__all__ = ["GF", "Field", "FieldArray", "FieldArrayMeta", "FieldMeta", "GF2"]
