"""Conway-polynomial lookup.

The packed table ``conway_polys.npz`` ships in this package (a byte-for-byte
copy of the JAX package's table, built from the public Luebeck tables); the
port reads its own copy and nothing of the JAX package.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ConwayPolyDatabase"]

_CONWAY_PATH = pathlib.Path(__file__).resolve().parent / "conway_polys.npz"


class _ConwayPolyDatabase:
    """Maps (characteristic, degree) -> (nonzero_degrees, nonzero_coeffs)."""

    def __init__(self, path: pathlib.Path = _CONWAY_PATH):
        with np.load(path) as z:
            index = z["index"]
            self._degrees = z["degrees"]
            self._coeffs = z["coeffs"]
        self._table: Dict[Tuple[int, int], Tuple[int, int]] = {
            (int(p), int(m)): (int(off), int(cnt)) for p, m, off, cnt in index
        }

    def fetch(self, characteristic: int, degree: int) -> Tuple[List[int], List[int]]:
        key = (int(characteristic), int(degree))
        if key not in self._table:
            raise LookupError(
                f"ConwayPolyDatabase has no entry for GF({characteristic}^{degree})."
            )
        off, cnt = self._table[key]
        return (
            [int(d) for d in self._degrees[off : off + cnt]],
            [int(c) for c in self._coeffs[off : off + cnt]],
        )


@functools.lru_cache(maxsize=None)
def ConwayPolyDatabase() -> _ConwayPolyDatabase:
    return _ConwayPolyDatabase()
