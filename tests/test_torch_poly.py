"""The Poly core of the torch port against the JAX package.

Construction, printing, host arithmetic and the batched device evaluation
``Poly(c)(x)`` (both Horner branches) over GF(2), GF(7), GF(2^8), GF(3^5)
and the Goldilocks field, and the slice of this port as a whole at a small
size: Goldilocks and GF(2^31 - 1) arithmetic and degree-70 evaluation over
2^10 elements. The same inputs, made with numpy from a seed, go through
``galois_tpu`` and ``galois_tpu_torch``; the tolerance is exact integer
equality.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu_torch.ops import _elementwise
from galois_tpu_torch.ops._poly_eval import evaluate_data

GOLDILOCKS = 2**64 - 2**32 + 1
M31 = 2**31 - 1
ORDERS = [2, 7, 2**8, 3**5, GOLDILOCKS]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _coeffs(order: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    c = [int(v) * 3 % order for v in rng.integers(0, 2**62, n)]
    c[0] = c[0] or 1
    return c


def _pair(q, coeffs, **kw):
    return gt.Poly(coeffs, field=gt.GF(q), **kw), gj.Poly(coeffs, field=gj.GF(q), **kw)


def _same_poly(pt, pj):
    assert isinstance(pt, gt.Poly)
    assert str(pt) == str(pj)
    assert repr(pt) == repr(pj)
    assert int(pt) == int(pj)
    assert pt.degree == pj.degree
    assert np.array_equal(pt.nonzero_degrees, pj.nonzero_degrees)
    _same(pt.nonzero_coeffs, pj.nonzero_coeffs)
    if pt.degree <= 10**6:  # sparse polys of larger degree have no dense array
        _same(pt.coeffs, pj.coeffs)


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("order", ORDERS)
def test_poly_construction_matches_jax(order):
    Ft, Fj = gt.GF(order), gj.GF(order)
    c = _coeffs(order, 6, seed=order % 101)
    _same_poly(*_pair(order, c))
    _same_poly(*_pair(order, c, order="asc"))
    _same_poly(*_pair(order, [0, 0] + c))
    _same_poly(gt.Poly(Ft(c)), gj.Poly(Fj(c)))
    _same_poly(gt.Poly.Zero(Ft), gj.Poly.Zero(Fj))
    _same_poly(gt.Poly.One(Ft), gj.Poly.One(Fj))
    _same_poly(gt.Poly.Identity(Ft), gj.Poly.Identity(Fj))
    _same_poly(gt.Poly.Random(9, seed=4, field=Ft), gj.Poly.Random(9, seed=4, field=Fj))
    _same_poly(gt.Poly.Int(int(gj.Poly(c, field=Fj)), field=Ft), gj.Poly(c, field=Fj))
    _same_poly(gt.Poly.Degrees([7, 2, 0], [1, 1, order - 1], field=Ft), gj.Poly.Degrees([7, 2, 0], [1, 1, order - 1], field=Fj))
    _same_poly(gt.Poly.Degrees([3, 1], field=Ft), gj.Poly.Degrees([3, 1], field=Fj))
    _same_poly(gt.Poly.Str("x^3 + x + 1", field=Ft), gj.Poly.Str("x^3 + x + 1", field=Fj))
    _same_poly(gt.Poly.Like("x^2 + 1", field=Ft), gj.Poly.Like("x^2 + 1", field=Fj))
    _same_poly(gt.Poly.Like(5, field=Ft), gj.Poly.Like(5, field=Fj))
    roots = [1, 2 % order, order - 1]
    _same_poly(gt.Poly.Roots(roots, field=Ft), gj.Poly.Roots(roots, field=Fj))
    _same_poly(gt.Poly.Roots(roots, [2, 1, 1], field=Ft), gj.Poly.Roots(roots, [2, 1, 1], field=Fj))
    pt, pj = _pair(order, c)
    _same(pt.coefficients(10), pj.coefficients(10))
    _same(pt.coefficients(order="asc"), pj.coefficients(order="asc"))
    assert (pt.is_monic, pt.is_zero, pt.is_one, len(pt)) == (pj.is_monic, pj.is_zero, pj.is_one, len(pj))
    assert hash(pt) == hash(pj) and pt.field is Ft
    _same_poly(pt.reverse(), pj.reverse())


def test_poly_default_field_and_sparse_forms_match_jax():
    _same_poly(gt.Poly([1, 0, 1, 1]), gj.Poly([1, 0, 1, 1]))  # GF(2), binary form
    assert gt.Poly([1, 1]).field is gt.GF2
    big_t = gt.Poly.Degrees([10**6, 3, 0], [2, 1, 5], field=gt.GF(7))
    big_j = gj.Poly.Degrees([10**6, 3, 0], [2, 1, 5], field=gj.GF(7))
    assert str(big_t) == str(big_j) and int(big_t) == int(big_j) and big_t._type == big_j._type == "sparse"
    m_t, m_j = gt.Poly([1, 0, 3], field=gt.GF(7)), gj.Poly([1, 0, 3], field=gj.GF(7))
    _same_poly(big_t % m_t, big_j % m_j)
    _same_poly(big_t * gt.Poly([1, 1], field=gt.GF(7)), big_j * gj.Poly([1, 1], field=gj.GF(7)))
    _same_poly(-gt.Poly([3, 1], field=gt.GF(7)), -gj.Poly([3, 1], field=gj.GF(7)))
    _same_poly(gt.Poly([-1, 2], field=gt.GF(7)), gj.Poly([-1, 2], field=gj.GF(7)))


@pytest.mark.parametrize("order", ORDERS)
def test_poly_arithmetic_matches_jax(order):
    a_t, a_j = _pair(order, _coeffs(order, 9, seed=1))
    b_t, b_j = _pair(order, _coeffs(order, 4, seed=2))
    _same_poly(a_t + b_t, a_j + b_j)
    _same_poly(a_t - b_t, a_j - b_j)
    _same_poly(b_t - a_t, b_j - a_j)
    _same_poly(a_t * b_t, a_j * b_j)
    q_t, r_t = divmod(a_t, b_t)
    q_j, r_j = divmod(a_j, b_j)
    _same_poly(q_t, q_j)
    _same_poly(r_t, r_j)
    _same_poly(a_t // b_t, a_j // b_j)
    _same_poly(a_t % b_t, a_j % b_j)
    _same_poly(b_t**3, b_j**3)
    _same_poly(b_t**0, b_j**0)
    _same_poly(pow(a_t, 5, b_t), pow(a_j, 5, b_j))
    _same_poly(a_t * 3, a_j * 3)
    _same_poly(a_t * gt.GF(order)(order - 1), a_j * gj.GF(order)(order - 1))
    _same_poly(a_t + 1, a_j + 1)
    _same_poly(a_t.derivative(), a_j.derivative())
    _same_poly(a_t.derivative(2), a_j.derivative(2))
    _same_poly(a_t(b_t), a_j(b_j))  # composition
    assert (a_t == a_t + 0) and (a_t != b_t) and (a_j == a_j + 0)
    assert (gt.Poly([1, 1], field=gt.GF(order)) == gt.Poly([1, 1], field=gt.GF(order))) is True
    with pytest.raises(ZeroDivisionError):
        divmod(a_t, gt.Poly.Zero(gt.GF(order)))
    with pytest.raises(NotImplementedError):
        a_t / b_t
    with pytest.raises(TypeError):
        a_t + gt.Poly([1, 1], field=gt.GF(3 if order != 3 else 5))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("degree", [10, 70])  # plain Horner, then the two-level form
def test_poly_evaluation_matches_jax(order, degree):
    c = _coeffs(order, degree + 1, seed=degree)
    pt, pj = _pair(order, c)
    rng = np.random.default_rng(order % 1000)
    x = np.array([int(v) % order for v in rng.integers(0, 2**62, 33)], dtype=object)
    x[:3] = [0, 1, order - 1]
    Ft, Fj = gt.GF(order), gj.GF(order)
    _same(pt(Ft(x)), pj(Fj(x)))
    _same(pt(Ft(x.reshape(3, 11))), pj(Fj(x.reshape(3, 11))))
    _same(pt(int(x[5])), pj(int(x[5])))  # a 0-d point
    _same(pt(x.tolist()), pj(x.tolist()))
    hf = get_host_field(Fj._meta)
    asc = c[::-1]
    ref = []
    for v in x[:8]:
        acc = 0
        for cc in reversed(asc):
            acc = hf.add(hf.multiply(acc, int(v)), cc)
        ref.append(acc)
    assert [int(v) for v in np.asarray(pt(Ft(x[:8])), dtype=object)] == ref


def test_poly_methods_left_for_later_raise():
    """Roots and the Conway predicates were left for a later slice
    (``polys/_roots.py``, ``polys/_conway.py``); now they match the JAX
    package."""
    f, g = gt.Poly([1, 0, 1, 1]), gj.Poly([1, 0, 1, 1])
    assert np.asarray(f.roots()).tolist() == np.asarray(g.roots()).tolist()
    assert f.is_conway() == g.is_conway() and f.is_conway_consistent() == g.is_conway_consistent()


# ----------------------------------------------------------------------
# GF(p^m, irreducible_poly=Poly(...)) and the field's irreducible_poly
# ----------------------------------------------------------------------

@pytest.mark.parametrize(
    ["order", "poly"],
    [(2**8, "x^8 + x^4 + x^3 + x^2 + 1"), (2**8, "x^8 + x^4 + x^3 + x + 1"), (3**5, "x^5 + x^4 + x^2 + 1"), (7**3, "x^3 + 3x + 2")],
)
def test_field_from_a_poly_matches_jax(order, poly):
    p = gt.factors(order)[0][0]
    Ft = gt.GF(order, irreducible_poly=gt.Poly.Str(poly, field=gt.GF(p)))
    Fj = gj.GF(order, irreducible_poly=gj.Poly.Str(poly, field=gj.GF(p)))
    assert Ft._meta.irreducible_poly_int == Fj._meta.irreducible_poly_int
    assert int(Ft.primitive_element) == int(Fj.primitive_element)
    assert gt.GF(order, irreducible_poly=poly) is Ft  # the same class as from the string
    _same_poly(Ft.irreducible_poly, Fj.irreducible_poly)
    rng = np.random.default_rng(order)
    a, b = rng.integers(0, order, 40), rng.integers(1, order, 40)
    _same(Ft(a) * Ft(b), Fj(a) * Fj(b))
    _same(Ft(a) / Ft(b), Fj(a) / Fj(b))


@pytest.mark.parametrize("order", [2, 7, 2**8, 3**5, 2**31 - 1, GOLDILOCKS])
def test_irreducible_poly_property_matches_jax(order):
    _same_poly(gt.GF(order).irreducible_poly, gj.GF(order).irreducible_poly)


# ----------------------------------------------------------------------
# The slice as a whole, small: main path 3 at 2^10 elements, degree 70
# ----------------------------------------------------------------------

def test_main_path_3_small_matches_jax():
    n = 2**10
    rng = np.random.default_rng(3)
    for p, ops in ((GOLDILOCKS, ("*", "+", "-", "recip", "/")), (M31, ("*", "/"))):
        Ft, Fj = gt.GF(p), gj.GF(p)
        hf = get_host_field(Fj._meta)
        x = np.array([int(v) % p for v in rng.integers(0, 2**62, n)], dtype=object)
        y = np.array([1 + int(v) % (p - 1) for v in rng.integers(0, 2**62, n)], dtype=object)
        xt, yt, xj, yj = Ft(x), Ft(y), Fj(x), Fj(y)
        for op in ops:
            if op == "*":
                _same(xt * yt, xj * yj)
            elif op == "+":
                _same(xt + yt, xj + yj)
            elif op == "-":
                _same(xt - yt, xj - yj)
            elif op == "recip":
                want = np.array([hf.reciprocal(int(v)) for v in y], dtype=object)
                _same(np.reciprocal(yt), want.astype(Fj.default_dtype))
            else:
                _same(xt / yt, xj / yj)
        c = _coeffs(p, 71, seed=p % 1000)
        pt, pj = gt.Poly(c, field=Ft), gj.Poly(c, field=Fj)
        _same(pt(xt), pj(xj))


def test_two_level_horner_multiplies_36_times_at_256_coefficients(monkeypatch):
    """The launch count of the main path: 16 inner + 4 for x^16 + 16 outer
    multiplies (the K10 or K9 wrapper on the card; its plain version here)."""
    calls = []
    for name in ("goldilocks_multiply", "m31_multiply"):
        real = getattr(_elementwise, name)
        monkeypatch.setattr(
            "galois_tpu_torch.ops._kernels." + name,
            lambda a, b, real=real, name=name: (calls.append(name), real(a, b))[1],
        )
    for p, name in ((GOLDILOCKS, "goldilocks_multiply"), (M31, "m31_multiply")):
        F = gt.GF(p)
        calls.clear()
        x = F.Random(64, seed=1)
        out = evaluate_data(F._meta, F._mode, _coeffs(p, 256, seed=9), x._data)
        assert calls == [name] * 36
        assert out.shape == x._data.shape
        calls.clear()
        F.Random(8, seed=2, low=1) ** -1
        assert len(calls) == (125 if p == GOLDILOCKS else 59)  # Fermat: p - 2 by square-and-multiply


# ----------------------------------------------------------------------
# Irreducibility, primitivity and the searches
# ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 3, 7, 2**4, 3**2])
def test_irreducible_and_primitive_tests_match_jax(order):
    rng = np.random.default_rng(order)
    for degree in (1, 2, 3, 4, 6):
        for _ in range(6):
            c = [int(v) for v in rng.integers(0, order, degree + 1)]
            c[0] = c[0] or 1
            pt, pj = _pair(order, c)
            assert pt.is_irreducible() == pj.is_irreducible(), c
            assert pt.is_primitive() == pj.is_primitive(), c
            assert gt.polys.is_irreducible(pt) == pj.is_irreducible()
    pt, pj = _pair(order, [1])
    assert pt.is_irreducible() is pj.is_irreducible() is False


@pytest.mark.parametrize(
    ["order", "degree"], [(2, 1), (2, 5), (2, 8), (2, 9), (3, 4), (5, 3), (7, 2)]
)
def test_poly_searches_match_jax(order, degree):
    for terms in (None, "min", 3 if degree >= 2 else 2):
        for method in ("min", "max"):
            try:
                want = gj.irreducible_poly(order, degree, terms=terms, method=method)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    gt.irreducible_poly(order, degree, terms=terms, method=method)
            else:
                _same_poly(gt.irreducible_poly(order, degree, terms=terms, method=method), want)
            try:
                want = gj.primitive_poly(order, degree, terms=terms, method=method)
            except RuntimeError:
                with pytest.raises(RuntimeError):
                    gt.primitive_poly(order, degree, terms=terms, method=method)
            else:
                _same_poly(gt.primitive_poly(order, degree, terms=terms, method=method), want)
    if order**degree <= 2**9:
        for reverse in (False, True):
            got = list(gt.primitive_polys(order, degree, reverse=reverse))
            want = list(gj.primitive_polys(order, degree, reverse=reverse))
            assert [int(f) for f in got] == [int(f) for f in want]
            got = list(gt.irreducible_polys(order, degree, terms="min"))
            assert [int(f) for f in got] == [int(f) for f in gj.irreducible_polys(order, degree, terms="min")]
    for seed in (1, 2):
        r = gt.primitive_poly(order, degree, method="random")  # a random one: primitive in JAX's eyes too
        assert r.degree == degree and gj.Poly(list(np.asarray(r.coeffs)), field=gj.GF(order)).is_primitive()


def test_matlab_primitive_poly_matches_jax():
    for m in range(1, 17):
        _same_poly(gt.matlab_primitive_poly(2, m), gj.matlab_primitive_poly(2, m))
    for p, m in ((3, 3), (3, 5), (5, 2), (7, 3)):
        _same_poly(gt.matlab_primitive_poly(p, m), gj.matlab_primitive_poly(p, m))
    assert int(gt.matlab_primitive_poly(2, 8)) == 0x11D and int(gt.matlab_primitive_poly(2, 9)) == 529


def test_irreducible_table_is_the_ports_own_copy():
    """The minimal-term table that irreducible_poly(terms="min") reads ships
    in the port, byte for byte the JAX package's."""
    import pathlib

    from galois_tpu_torch import _databases

    repo = pathlib.Path(__file__).resolve().parent.parent
    path = _databases._IRREDUCIBLE_PATH
    assert path.parent == repo / "galois_tpu_torch" / "_databases" and path.exists()
    assert path.read_bytes() == (repo / "galois_tpu" / "_databases" / "irreducible_polys.npz").read_bytes()
    for p, m in ((2, 8), (2, 100), (3, 7), (7, 5)):
        _same_poly(gt.irreducible_poly(p, m, terms="min"), gj.irreducible_poly(p, m, terms="min"))


# ----------------------------------------------------------------------
# Element methods: minimal poly, multiplicative order, roots of unity
# ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [2**8, 2**9, 3**5, 257, 2**31 - 1, GOLDILOCKS])
def test_element_methods_match_jax(order):
    Ft, Fj = gt.GF(order), gj.GF(order)
    rng = np.random.default_rng(order % 1000)
    x = np.array([1 + int(v) % (order - 1) for v in rng.integers(0, 2**62, 12)], dtype=object)
    if order < 2**63:
        x = x.astype(np.int64)
    got = Ft(x).multiplicative_order()
    want = Fj(x).multiplicative_order()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert Ft(x[3]).multiplicative_order() == Fj(x[3]).multiplicative_order()
    assert type(Ft(x[3]).multiplicative_order()) is type(Fj(x[3]).multiplicative_order())
    with pytest.raises(ArithmeticError):
        Ft([0, 1]).multiplicative_order()
    for v in x[:4]:
        _same_poly(Ft(v).minimal_poly(), Fj(v).minimal_poly())
        _same_poly(Ft(v).characteristic_poly(), Fj(v).characteristic_poly())
    for n in (1, 2, 3, 5, 15, 17, 255, 511, order - 1):
        if (order - 1) % n or n >= order:
            continue
        _same(Ft.primitive_root_of_unity(n), Fj.primitive_root_of_unity(n))
        if n <= 512:
            _same(Ft.primitive_roots_of_unity(n), Fj.primitive_roots_of_unity(n))
    with pytest.raises(ValueError):
        Ft.primitive_root_of_unity(order)


# ----------------------------------------------------------------------
# The field matmul and matrix evaluation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 2**8, 2**9, 3**2, 7, 2**31 - 1, 251**2])
def test_matmul_matches_jax(order):
    Ft, Fj = gt.GF(order), gj.GF(order)
    rng = np.random.default_rng(order % 1000)

    def arr(*shape):
        return rng.integers(0, order, shape)

    cases = [
        (arr(3, 4), arr(4, 5)),
        (arr(4), arr(4, 5)),  # 1-D promotion on each side, and both
        (arr(3, 4), arr(4)),
        (arr(4), arr(4)),
        (arr(2, 3, 4), arr(4, 5)),  # batching
        (arr(2, 3, 4), arr(2, 4, 2)),
        (arr(6, 300), arr(300, 2)),  # GF(251^2): past the digit planes' exact range
    ]
    for a, b in cases:
        want = Fj(a) @ Fj(b)
        _same(Ft(a) @ Ft(b), want)
        _same(np.matmul(Ft(a), Ft(b)), want)
        _same(Ft(a) @ b, want)  # a host operand is coerced
    _same(Ft(cases[0][0]).T, Fj(cases[0][0]).T)
    _same(Ft(cases[4][0]).T, Fj(cases[4][0]).T)
    with pytest.raises(ValueError):
        Ft(arr(3)) @ Ft(arr(3, 3))[0, 0]
    _same(Ft.Identity(4), Fj.Identity(4))


def test_limb_field_matmul_is_left_for_later():
    """Once a raise (the limb matmul was not ported); now the limb matmul of
    ops/_limb_matmul.py against the JAX package's, over Goldilocks."""
    F, Fj = gt.GF(GOLDILOCKS), gj.GF(GOLDILOCKS)
    a, b = [[1, 2], [GOLDILOCKS - 1, 5]], [[3], [4]]
    _same(F(a) @ F(b), Fj(a) @ Fj(b))


@pytest.mark.parametrize(["order", "n"], [(2**8, 4), (7, 3), (2**31 - 1, 3)])
def test_poly_matrix_evaluation_matches_jax(order, n):
    rng = np.random.default_rng(n)
    X = rng.integers(0, order, (n, n))
    c = _coeffs(order, 7, seed=order % 97)
    pt, pj = _pair(order, c)
    _same(pt(gt.GF(order)(X), elementwise=False), pj(gj.GF(order)(X), elementwise=False))
    with pytest.raises(ValueError):
        pt(gt.GF(order)(X[:, :2]), elementwise=False)


@pytest.mark.parametrize("order", [2, 2**8, 7, 3**5, GOLDILOCKS])
def test_poly_divmod_device_matches_jax(order):
    from galois_tpu.ops._poly_div import poly_divmod_device as divmod_j
    from galois_tpu_torch.ops._poly_div import poly_divmod_device as divmod_t

    for da, db, seed in ((30, 7, 1), (12, 12, 2), (5, 9, 3), (9, 0, 4)):
        at, aj = _pair(order, _coeffs(order, da + 1, seed))
        bt, bj = _pair(order, _coeffs(order, db + 1, seed + 10))
        (qt, rt), (qj, rj) = divmod_t(at, bt), divmod_j(aj, bj)
        _same_poly(qt, qj)
        _same_poly(rt, rj)
