"""Forward error-correction codes."""

from ._bch import BCH
from ._linear import generator_to_parity_check_matrix, parity_check_to_generator_matrix
from ._rs import ReedSolomon

__all__ = [
    "BCH",
    "ReedSolomon",
    "generator_to_parity_check_matrix",
    "parity_check_to_generator_matrix",
]
