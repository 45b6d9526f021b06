"""The int-or-Poly functions of the torch port against the JAX package.

``gcd``, ``egcd``, ``lcm``, ``prod``, ``are_coprime``, ``crt``, ``factors``
and ``is_square_free`` take ints or Polys; Polys over GF(7), GF(2^4) and
GF(3^2) with coefficients drawn by numpy from a seed go to both packages,
and the results must be equal (Polys compared by their integer
representation and string). The Poly factorization methods are held the
same way. Exact equality throughout.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt

ORDERS = [7, 2**4, 3**2]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _key(x):
    """A result in comparable form: Polys by int and str, containers item by item."""
    if isinstance(x, (gt.Poly, gj.Poly)):
        return ("poly", int(x), str(x))
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


def _polys(order, seed, degrees):
    """One list of descending coefficients per degree, leading ones nonzero,
    made into a Poly of each package."""
    rng = np.random.default_rng(seed)
    coeffs = []
    for d in degrees:
        c = rng.integers(0, order, d + 1).tolist()
        c[0] = int(rng.integers(1, order))
        coeffs.append(c)
    Ft, Fj = gt.GF(order), gj.GF(order)
    return [gt.Poly(c, field=Ft) for c in coeffs], [gj.Poly(c, field=Fj) for c in coeffs]


@pytest.mark.parametrize(
    ["name", "args"],
    [
        ("gcd", (84, 126)),
        ("egcd", (240, 46)),
        ("lcm", (4, 6, 10)),
        ("prod", (3, 5, 7)),
        ("are_coprime", (4, 9, 25)),
        ("are_coprime", (4, 6)),
        ("crt", ([2, 3, 2], [3, 5, 7])),
        ("factors", (2**4 * 3**3 * 101,)),
        ("is_square_free", (30,)),
        ("is_square_free", (12,)),
    ],
)
def test_int_arguments_match_jax(name, args):
    assert _key(getattr(gt, name)(*args)) == _key(getattr(gj, name)(*args))


@pytest.mark.parametrize("order", ORDERS)
def test_poly_arguments_match_jax(order):
    (a, b, c, m1, m2), (aj, bj, cj, m1j, m2j) = _polys(order, order, [3, 2, 2, 2, 3])
    cases = [
        ("gcd", (a * b, b * c), (aj * bj, bj * cj)),
        ("egcd", (a, b), (aj, bj)),
        ("lcm", (a, b * c, c), (aj, bj * cj, cj)),
        ("prod", (a, b, c), (aj, bj, cj)),
        ("are_coprime", (a, b), (aj, bj)),
        ("are_coprime", (a * c, b * c), (aj * cj, bj * cj)),
        ("factors", (a * a * b,), (aj * aj * bj,)),
        ("factors", (a * b * c,), (aj * bj * cj,)),
        ("is_square_free", (a * a * b,), (aj * aj * bj,)),
        ("is_square_free", (a,), (aj,)),
    ]
    for name, targs, jargs in cases:
        assert _key(getattr(gt, name)(*targs)) == _key(getattr(gj, name)(*jargs)), name
    assert gt.are_coprime(a * c, b * c) is False
    # crt where the moduli are coprime in the JAX package's own judgement
    if gj.are_coprime(m1j, m2j):
        got = gt.crt([a % m1, b % m2], [m1, m2])
        assert _key(got) == _key(gj.crt([aj % m1j, bj % m2j], [m1j, m2j]))
        assert got % m1 == a % m1 and got % m2 == b % m2


@pytest.mark.parametrize("order", ORDERS)
def test_poly_factor_methods_match_jax(order):
    (a, b), (aj, bj) = _polys(order, 10 + order, [2, 3])
    f, fj = a * a * b, aj * aj * bj
    assert _key(f.square_free_factors()) == _key(fj.square_free_factors())
    assert _key(f.factors()) == _key(fj.factors())
    assert f.is_square_free() == fj.is_square_free()
    sq_t, sq_j = a * b, aj * bj
    if sq_j.is_square_free():
        assert _key(sq_t.distinct_degree_factors()) == _key(sq_j.distinct_degree_factors())
    # a product of two distinct monic linear factors splits in the equal-degree stage
    Ft, Fj = gt.GF(order), gj.GF(order)
    lin_t = gt.Poly([1, 1], field=Ft) * gt.Poly([1, 2], field=Ft)
    lin_j = gj.Poly([1, 1], field=Fj) * gj.Poly([1, 2], field=Fj)
    assert _key(lin_t.equal_degree_factors(1)) == _key(lin_j.equal_degree_factors(1))


def test_gcd_of_a_product_over_gf7():
    """gcd(a b, b) = x + 1 over GF(7), with a = x^2 + 2x + 3 and b = x + 1."""
    Ft, Fj = gt.GF(7), gj.GF(7)
    a, b = gt.Poly([1, 2, 3], field=Ft), gt.Poly([1, 1], field=Ft)
    aj, bj = gj.Poly([1, 2, 3], field=Fj), gj.Poly([1, 1], field=Fj)
    got = gt.gcd(a * b, b)
    assert got == gt.Poly([1, 1], field=Ft) and str(got) == "x + 1"
    assert _key(got) == _key(gj.gcd(aj * bj, bj))


def test_mixed_arguments_raise_type_error():
    Ft, Fj = gt.GF(7), gj.GF(7)
    for pkg, F in ((gt, Ft), (gj, Fj)):
        p = pkg.Poly([1, 1], field=F)
        for call in (
            lambda: pkg.gcd(3, p), lambda: pkg.egcd(p, 3), lambda: pkg.lcm(2, p), lambda: pkg.prod(p, 2),
            lambda: pkg.are_coprime(p, 2), lambda: pkg.crt([1, p], [3, 5]), lambda: pkg.factors(1.5),
            lambda: pkg.is_square_free("x"),
        ):
            with pytest.raises(TypeError):
                call()
