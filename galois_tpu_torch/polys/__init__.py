"""Polynomials over Galois fields: the core of ``Poly`` (construction,
host arithmetic, batched evaluation) and the host representation
conversions."""

from ._poly import Poly

__all__ = ["Poly"]
