"""Odd-characteristic extension fields and user-given field parameters of
the torch port against the JAX package.

Field construction (Conway defaults, user irreducible polynomials and
primitive elements, Rabin's irreducibility test, the primitive-element
search), the host field and the host polynomial layer are compared with
``galois_tpu`` on the same arguments; results are exact integers.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field as jax_host_field
from galois_tpu.polys import _hostpoly as jax_hp
from galois_tpu_torch.fields._hostfield import get_host_field
from galois_tpu_torch.polys import _hostpoly as hp

ODD_ORDERS = [3**5, 5**3, 7**4, 3**10]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _props(F):
    meta = F._meta
    return (
        F.characteristic,
        F.degree,
        F.order,
        meta.irreducible_poly_int,
        int(F.primitive_element),
        meta.internal_dtype,
        F.dtypes,
        F.ufunc_modes,
        F.default_ufunc_mode,
        F.is_prime_field,
        F.is_extension_field,
    )


@pytest.mark.parametrize("order", ODD_ORDERS)
def test_odd_field_properties_match_jax(order):
    Ft, Fj = gt.GF(order), gj.GF(order)
    assert _props(Ft) == _props(Fj)
    assert np.array_equal(Ft._meta.reduction_matrix, Fj._meta.reduction_matrix)
    assert Ft._meta.irreducible_coeffs == Fj._meta.irreducible_coeffs
    x = order // 3 + 1
    assert Ft._meta.int_to_digits(x) == Fj._meta.int_to_digits(x)
    assert Ft._meta.digits_to_int(Ft._meta.int_to_digits(x)) == x
    assert gt.GF(Ft.characteristic, Ft.degree) is Ft


@pytest.mark.parametrize(
    ["order", "poly"],
    [
        (2**8, 0x11B),  # AES; x is not primitive, so alpha is searched
        (2**8, "x^8 + x^4 + x^3 + x^2 + 1"),  # CCSDS RS(255,223)
        (2**8, [1, 0, 0, 0, 1, 1, 1, 0, 1]),
        (3**5, "x^5 + 2x + 1"),  # the Conway polynomial, given explicitly
        (3**5, "x^5 + x^4 + x^2 + 1"),
        (3**5, [1, 0, 0, 0, 2, 2]),
        (5**3, "x^3 + x + 1"),
    ],
)
def test_user_irreducible_poly_matches_jax(order, poly):
    Ft, Fj = gt.GF(order, irreducible_poly=poly), gj.GF(order, irreducible_poly=poly)
    assert _props(Ft) == _props(Fj)
    rng = np.random.default_rng(order)
    a, b = rng.integers(0, order, 50), rng.integers(1, order, 50)
    for op in (lambda x, y: x * y, lambda x, y: x / y, lambda x, y: x - y):
        assert np.array_equal(np.asarray(op(Ft(a), Ft(b))), np.asarray(op(Fj(a), Fj(b))))


def test_smallest_primitive_element_for_non_conway_polys():
    assert int(gt.GF(2**8, irreducible_poly=0x11B).primitive_element) == 3
    for order, poly in ((2**8, 0x11B), (3**5, "x^5 + x^4 + x^2 + 1"), (3**5, "x^5 + 2x + 2")):
        Ft = gt.GF(order, irreducible_poly=poly)
        assert int(Ft.primitive_element) == int(gj.GF(order, irreducible_poly=poly).primitive_element)


def test_user_primitive_element_matches_jax():
    for order, alpha in ((2**8, 6), (3**5, 5), (3**5, "x + 1")):
        Ft, Fj = gt.GF(order, primitive_element=alpha), gj.GF(order, primitive_element=alpha)
        assert _props(Ft) == _props(Fj)
        x = np.arange(1, 40)
        Ft.compile("jit-lookup")
        Fj.compile("jit-lookup")
        try:
            assert np.array_equal(Ft(x).log(), Fj(x).log())
        finally:
            Ft.compile("auto")
            Fj.compile("auto")


def test_bad_field_arguments_raise_like_jax():
    for pkg in (gt, gj):
        with pytest.raises(ValueError):
            pkg.GF(2**8, irreducible_poly="x^8 + 1")  # reducible: (x + 1)^8
        with pytest.raises(ValueError):
            pkg.GF(3**5, irreducible_poly="x^5 + x + 1")  # reducible over GF(3)
        with pytest.raises(ValueError):
            pkg.GF(2**8, irreducible_poly="x^7 + x + 1")  # wrong degree
        with pytest.raises(ValueError):
            pkg.GF(2**8, primitive_element=1)  # not primitive
        with pytest.raises(ValueError):
            pkg.GF(3**5, primitive_element=2)  # in GF(3): order 2
    with pytest.raises(TypeError):
        # the port takes its own Poly (tests/test_torch_poly.py), not another package's
        gt.GF(2**8, irreducible_poly=gj.Poly.Str("x^8 + x^4 + x^3 + x^2 + 1"))
    # verify=False takes the polynomial as given, in both packages
    kw = dict(irreducible_poly="x^5 + x + 1", primitive_element=3, verify=False)
    assert gt.GF(3**5, **kw)._meta.irreducible_poly_int == gj.GF(3**5, **kw)._meta.irreducible_poly_int


@pytest.mark.parametrize("order", [2**8, 3**5, 7**4])
def test_host_field_matches_jax(order):
    ht, hj = get_host_field(gt.GF(order)._meta), jax_host_field(gj.GF(order)._meta)
    for a in [0, 1, 2, order // 2, order - 1]:
        assert ht.to_coeffs(a) == hj.to_coeffs(a) and ht.from_coeffs(ht.to_coeffs(a)) == a
        assert ht.negative(a) == hj.negative(a)
        assert ht.is_square(a) == hj.is_square(a)
        assert ht.is_primitive_element(a) == hj.is_primitive_element(a)
        for b in (1, 3, order - 2):
            assert ht.add(a, b) == hj.add(a, b)
            assert ht.subtract(a, b) == hj.subtract(a, b)
            assert ht.multiply(a, b) == hj.multiply(a, b)
            assert ht.divide(a, b) == hj.divide(a, b)
        if a:
            assert ht.multiplicative_order(a) == hj.multiplicative_order(a)


def test_host_polys_match_jax():
    F = get_host_field(gt.GF(3**2)._meta)
    Fj = jax_host_field(gj.GF(3**2)._meta)
    rng = np.random.default_rng(2)
    for _ in range(10):
        a = [int(v) for v in rng.integers(0, 9, rng.integers(1, 7))]
        b = [int(v) for v in rng.integers(0, 9, rng.integers(1, 5))] + [1]
        assert hp.add(F, a, b) == jax_hp.add(Fj, a, b)
        assert hp.sub(F, a, b) == jax_hp.sub(Fj, a, b)
        assert hp.mul(F, a, b) == jax_hp.mul(Fj, a, b)
        assert hp.divmod_(F, a, b) == jax_hp.divmod_(Fj, a, b)
        assert hp.gcd(F, a, b) == jax_hp.gcd(Fj, a, b)
        assert hp.egcd(F, a, b) == jax_hp.egcd(Fj, a, b)
        assert hp.pow_mod(F, a, 11, b) == jax_hp.pow_mod(Fj, a, 11, b)
        assert hp.derivative(F, a) == jax_hp.derivative(Fj, a)
        assert hp.evaluate(F, a, 5) == jax_hp.evaluate(Fj, a, 5)
