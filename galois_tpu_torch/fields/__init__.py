"""Finite-field arrays of the torch port: the GF() factory, FieldArray, and
the primitive and normal element functions."""

from . import _methods  # noqa: F401  (attaches the element and root-of-unity methods)
from ._array import Array, FieldArray, FieldArrayMeta
from ._factory import GF, Field
from ._meta import FieldMeta
from ._normal_element import is_normal_element, normal_element, normal_elements
from ._primitive_element import is_primitive_element, primitive_element, primitive_elements

GF2 = GF(2)

__all__ = [
    "GF", "Field", "Array", "FieldArray", "FieldArrayMeta", "FieldMeta", "GF2",
    "is_primitive_element", "primitive_element", "primitive_elements",
    "is_normal_element", "normal_element", "normal_elements",
]
