"""Package-global print options.

API parity with the reference's ``set_printoptions`` / ``get_printoptions`` /
``printoptions`` (reference: src/galois/_options.py:17-134).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Generator

__all__ = ["set_printoptions", "get_printoptions", "printoptions"]

_PRINTOPTIONS: Dict[str, Any] = {
    "coeffs": "desc",
}


def set_printoptions(coeffs: str = "desc") -> None:
    """Set package-wide print options.

    Arguments:
        coeffs: Order in which to print polynomial coefficients, either
            ``"desc"`` (highest degree first, the default) or ``"asc"``.
    """
    if coeffs not in ("desc", "asc"):
        raise ValueError(f"Argument 'coeffs' must be 'desc' or 'asc', not {coeffs!r}.")
    _PRINTOPTIONS["coeffs"] = coeffs


def get_printoptions() -> Dict[str, Any]:
    """Return the current package-wide print options."""
    return dict(_PRINTOPTIONS)


@contextlib.contextmanager
def printoptions(**kwargs: Any) -> Generator[None, None, None]:
    """Context manager that temporarily modifies the print options."""
    saved = dict(_PRINTOPTIONS)
    try:
        set_printoptions(**kwargs)
        yield
    finally:
        _PRINTOPTIONS.clear()
        _PRINTOPTIONS.update(saved)
