"""The port's prime-factors table (its own copy of the Cunningham-style
factorizations of b^n +- 1) against the JAX package.

``factors`` reads the table before trial division and Pollard rho: numbers
such as 2^122 - 1 and 2^128 + 1 hold two primes above 10^15 that rho cannot
split in any reasonable time. Each factorization must equal the JAX
package's and finish within 2 s.
"""

import time

import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu._databases import PrimeFactorsDatabase as JaxPrimeFactorsDatabase
from galois_tpu_torch._databases import PrimeFactorsDatabase
from galois_tpu_torch.nt.factorization import _factors_cached


@pytest.mark.parametrize("n", [2**122 - 1, 2**128 + 1, 7**43 - 1], ids=["2^122-1", "2^128+1", "7^43-1"])
def test_factors_from_the_table_match_jax(n):
    _factors_cached.cache_clear()
    t0 = time.perf_counter()
    got = gt.factors(n)
    elapsed = time.perf_counter() - t0
    assert got == gj.factors(n)
    assert elapsed < 2.0, f"factors({n}) took {elapsed:.2f} s"
    ps, es = got
    prod = 1
    for p, e in zip(ps, es):
        assert gt.is_prime(p)
        prod *= p**e
    assert prod == n


def test_table_matches_jax_and_merges_a_residual():
    db, jdb = PrimeFactorsDatabase(), JaxPrimeFactorsDatabase()
    assert db._table == jdb._table  # the port's copy holds the same 2007 entries
    residual = next(n for n, (_, _, rest) in sorted(db._table.items()) if rest > 1 and rest.bit_length() < 90)
    ps, es, rest = db.fetch(residual)
    assert (ps, es, rest) == jdb.fetch(residual) and rest > 1
    assert residual in db and residual + 2 not in db
    with pytest.raises(LookupError):
        db.fetch(residual + 2)
    _factors_cached.cache_clear()
    fp, fe = gt.factors(residual)
    assert (fp, fe) == tuple(gj.factors(residual))
    assert set(ps) <= set(fp) and any(p not in ps for p in fp)  # the residual was split and merged


def test_gf2_122_builds():
    t0 = time.perf_counter()
    F = gt.GF(2**122, irreducible_poly="x^122 + x^6 + x^2 + x + 1")
    assert time.perf_counter() - t0 < 30
    Fj = gj.GF(2**122, irreducible_poly="x^122 + x^6 + x^2 + x + 1")
    assert F._meta.primitive_element_int == Fj._meta.primitive_element_int
