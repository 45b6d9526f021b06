"""Conway-polynomial and minimal-term irreducible-polynomial lookup.

The packed tables ``conway_polys.npz`` and ``irreducible_polys.npz`` ship in
this package (byte-for-byte copies of the JAX package's tables, built from
the public Luebeck and Wolfram tables); the port reads its own copies and
nothing of the JAX package.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ConwayPolyDatabase", "IrreduciblePolyDatabase"]

_CONWAY_PATH = pathlib.Path(__file__).resolve().parent / "conway_polys.npz"
_IRREDUCIBLE_PATH = _CONWAY_PATH.with_name("irreducible_polys.npz")


class _SparsePolyDatabase:
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
                f"{type(self).__name__} has no entry for GF({characteristic}^{degree})."
            )
        off, cnt = self._table[key]
        return (
            [int(d) for d in self._degrees[off : off + cnt]],
            [int(c) for c in self._coeffs[off : off + cnt]],
        )


class _ConwayPolyDatabase(_SparsePolyDatabase):
    pass


class _IrreduciblePolyDatabase(_SparsePolyDatabase):
    pass


@functools.lru_cache(maxsize=None)
def ConwayPolyDatabase() -> _ConwayPolyDatabase:
    return _ConwayPolyDatabase()


@functools.lru_cache(maxsize=None)
def IrreduciblePolyDatabase() -> _IrreduciblePolyDatabase:
    return _IrreduciblePolyDatabase(_IRREDUCIBLE_PATH)
