"""Conway-polynomial and minimal-term irreducible-polynomial lookup.

The packed tables ``conway_polys.npz`` and ``irreducible_polys.npz`` ship in
this package (byte-for-byte copies of the JAX package's tables, built from
the public Luebeck and Wolfram tables), and so does ``prime_factors.txt.gz``,
the Cunningham-style factorizations of b^n +- 1; the port reads its own
copies and nothing of the JAX package.
"""

from __future__ import annotations

import functools
import gzip
import pathlib
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["ConwayPolyDatabase", "IrreduciblePolyDatabase", "PrimeFactorsDatabase"]

_CONWAY_PATH = pathlib.Path(__file__).resolve().parent / "conway_polys.npz"
_IRREDUCIBLE_PATH = _CONWAY_PATH.with_name("irreducible_polys.npz")
_PRIME_FACTORS_PATH = _CONWAY_PATH.with_name("prime_factors.txt.gz")


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


class _PrimeFactorsDatabase:
    """Cunningham-style factorizations of b^n +- 1, keyed by the value.

    ``fetch(n) -> (factors, multiplicities, residual)``: the residual is the
    composite cofactor the table leaves unsplit, 1 when the factorization is
    complete (the reference's contract, src/galois/_databases/_interface.py).
    Entries hold prime pairs above 10^15 (2^122 - 1, 2^128 + 1) that Pollard
    rho cannot split in any reasonable time."""

    def __init__(self, path: pathlib.Path = _PRIME_FACTORS_PATH):
        self._table: Dict[int, Tuple[List[int], List[int], int]] = {}
        with gzip.open(path, "rt") as fh:
            for line in fh:
                value, ps, es, rest = line.split()
                self._table[int(value)] = (
                    [] if ps == "-" else [int(x) for x in ps.split(",")],
                    [] if es == "-" else [int(x) for x in es.split(",")],
                    int(rest),
                )

    def fetch(self, n: int) -> Tuple[List[int], List[int], int]:
        entry = self._table.get(int(n))
        if entry is None:
            raise LookupError(f"PrimeFactorsDatabase has no entry for {n}.")
        ps, es, rest = entry
        return list(ps), list(es), rest

    def __contains__(self, n: int) -> bool:
        return int(n) in self._table


@functools.lru_cache(maxsize=None)
def PrimeFactorsDatabase() -> _PrimeFactorsDatabase:
    return _PrimeFactorsDatabase()


@functools.lru_cache(maxsize=None)
def ConwayPolyDatabase() -> _ConwayPolyDatabase:
    return _ConwayPolyDatabase()


@functools.lru_cache(maxsize=None)
def IrreduciblePolyDatabase() -> _IrreduciblePolyDatabase:
    return _IrreduciblePolyDatabase(_IRREDUCIBLE_PATH)
