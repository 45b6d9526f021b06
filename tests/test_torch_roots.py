"""Roots, Conway and Lagrange polynomials, and primitive and normal elements
of the torch port against the JAX package.

``Poly.roots`` with and without multiplicities on both of its routes (the
Chien scan over ``field.elements`` for orders <= 2^20, the host's linear
factors above), ``conway_poly``, ``Poly.is_conway``,
``Poly.is_conway_consistent``, ``lagrange_poly``, and the top-level
``primitive_element(s)``, ``is_primitive_element``, ``normal_element(s)``
and ``is_normal_element``. The same inputs, made with numpy from a seed, go
through ``galois_tpu`` and ``galois_tpu_torch`` on the CPU; the tolerance is
exact equality of the integers (and of the polynomials' strings), and the
exception types must agree.

Known deviations, where the port raises TypeError as the reference galois
does and the JAX package does not (it raises AttributeError or returns):
a first argument that is not a Poly (``primitive_element(7)``,
``normal_element(GF)``) and an element that is not an int, a Poly or a
polynomial string in x (``is_primitive_element('a', f)``).
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu_torch.fields import _factory as torch_factory
from galois_tpu_torch.polys import _roots

M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1


@pytest.fixture(autouse=True, scope="module")
def _on_cpu_and_restore_modes():
    """The plain versions serve CPU tensors: ask for the CPU, since new data
    goes to CUDA by default. Put every cached field class back in its mode,
    so that no lookup-mode class leaks into later tests of this worker."""
    caches = (jax_factory._FIELD_CACHE, torch_factory._FIELD_CACHE)
    saved = [{k: cls._mode for k, cls in c.items()} for c in caches]
    with gt.default_device("cpu"):
        yield
    for cache, modes in zip(caches, saved):
        for k, cls in cache.items():
            cls._mode = modes.get(k, cls._meta.default_ufunc_mode)


def outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001  (the type is compared)
        return type(e)


def same_array(a, b):
    assert type(a).name == type(b).name and a.shape == b.shape and a.dtype == b.dtype
    assert np.asarray(a).tolist() == np.asarray(b).tolist()


def same_poly(a, b):
    assert type(a).__name__ == type(b).__name__ == "Poly"
    assert a.field.name == b.field.name and str(a) == str(b) and int(a) == int(b)


def random_roots(q, k, rng):
    """k distinct nonzero int reprs of GF(q) (object ints above 2^62)."""
    if q <= 2**62:
        return [int(v) for v in rng.choice(np.arange(1, min(q, 2**20)), k, replace=False)]
    return sorted({int(rng.integers(1, 2**62)) * 4099 % q for _ in range(k)})


# (id, order, mode): orders <= 2^20 scan every element on the device
ROOT_CASES = [
    ("GF7", 7, "jit-calculate"), ("GF16", 2**4, "jit-calculate"), ("GF256", 2**8, "jit-calculate"),
    ("GF256", 2**8, "jit-lookup"), ("GF243", 3**5, "jit-calculate"), ("GF65536", 2**16, "jit-calculate"),
    ("M31", M31, "jit-calculate"), ("Goldilocks", GOLDILOCKS, "jit-calculate"),
]


@pytest.mark.parametrize(["fid", "q", "mode"], ROOT_CASES, ids=[f"{c[0]}-{c[2][4:]}" for c in ROOT_CASES])
def test_roots_match_jax(fid, q, mode):
    """Poly.Roots of distinct roots with multiplicities up to 3 (0 among the
    roots), times an irreducible quadratic for the host route: the roots,
    ascending, and their multiplicities."""
    rng = np.random.default_rng(q % 1000 + 21)
    roots = random_roots(q, min(q - 1, 6), rng)
    roots[0] = 0
    mults = [int(m) for m in rng.integers(1, 4, len(roots))]
    polys = []
    for G in (gt, gj):
        F = G.GF(q, compile=mode)
        f = G.Poly.Roots(roots, mults, field=F)
        if q > 2**20:  # x^2 - alpha has no root: alpha is a non-square
            f = f * G.Poly([1, 0, q - int(F.primitive_element)], field=F)
        polys.append(f)
    same_poly(*polys)
    (rt, mt), (rj, mj) = (f.roots(multiplicity=True) for f in polys)
    same_array(rt, rj)
    assert mt.dtype == mj.dtype and mt.tolist() == mj.tolist()
    same_array(polys[0].roots(), polys[1].roots())
    assert sorted(np.asarray(rt).tolist()) == sorted(set(roots))


@pytest.mark.parametrize("q", [7, 2**8, M31])
def test_roots_of_constants_and_rootless_polys(q):
    for coeffs in ([5], [1, 0, 1, 1], [1, 1, 1]):
        out = []
        for G in (gt, gj):
            f = G.Poly(coeffs, field=G.GF(q))
            out.append((f.roots(), f.roots(multiplicity=True)))
        same_array(out[0][0], out[1][0])
        same_array(out[0][1][0], out[1][1][0])
        assert out[0][1][1].tolist() == out[1][1][1].tolist()


def test_roots_routes(monkeypatch):
    """The Chien scan for orders <= 2^20, the host factors above."""
    calls = []
    for name in ("_chien_roots", "_factor_roots"):
        fn = getattr(_roots, name)
        monkeypatch.setattr(_roots, name, lambda p, _fn=fn, _name=name: calls.append(_name) or _fn(p))
    for q, route in ((2**16, "_chien_roots"), (2**20, "_chien_roots"), (2**20 + 7, "_factor_roots"), (M31, "_factor_roots")):
        calls.clear()
        gt.Poly.Roots([1, 2], field=gt.GF(q)).roots()
        assert calls == [route]


@pytest.mark.parametrize(["p", "m"], [(2, 1), (2, 8), (2, 20), (3, 5), (5, 3), (7, 4), (65537, 2), (2, 409)])
def test_conway_poly_matches_jax(p, m):
    a, b = outcome(lambda: gt.conway_poly(p, m)), outcome(lambda: gj.conway_poly(p, m))
    if isinstance(a, type):
        assert a is b
        return
    same_poly(a, b)
    if m <= 8:
        assert a.is_conway() == b.is_conway() is True
        assert a.is_conway_consistent() == b.is_conway_consistent() is True


@pytest.mark.parametrize(["p", "coeffs"], [(2, [1, 0, 1, 1]), (2, [1, 1, 0, 1]), (3, [1, 0, 2, 1]), (3, [1, 2, 0, 0, 0, 1]), (5, [1, 0, 1])])
def test_is_conway_predicates_match_jax(p, coeffs):
    ft, fj = gt.Poly(coeffs, field=gt.GF(p)), gj.Poly(coeffs, field=gj.GF(p))
    for name in ("is_conway", "is_conway_consistent"):
        assert getattr(ft, name)() == getattr(fj, name)()


def test_conway_errors_match_jax():
    for args in ((4, 2), (2, 0)):
        assert outcome(lambda: gt.conway_poly(*args)) is outcome(lambda: gj.conway_poly(*args))
    ft, fj = gt.Poly([1, 1, 2], field=gt.GF(3**2)), gj.Poly([1, 1, 2], field=gj.GF(3**2))
    assert outcome(ft.is_conway) is outcome(fj.is_conway) is ValueError


@pytest.mark.parametrize("q", [7, 2**8, 3**5, M31, GOLDILOCKS])
def test_lagrange_poly_matches_jax(q):
    rng = np.random.default_rng(q % 1000 + 22)
    x = np.array(random_roots(q, min(q - 1, 9), rng), dtype=object)
    y = np.array([int(v) % q for v in rng.integers(0, 2**62, len(x))], dtype=object)
    ft = gt.lagrange_poly(gt.GF(q)(x), gt.GF(q)(y))
    same_poly(ft, gj.lagrange_poly(gj.GF(q)(x), gj.GF(q)(y)))
    assert np.asarray(ft(gt.GF(q)(x))).tolist() == y.tolist()
    for args in (lambda G: (G.GF(q)([1, 1]), G.GF(q)([1, 2])), lambda G: (G.GF(q)([1]), G.GF(q)([1, 2])),
                 lambda G: ([1, 2], G.GF(q)([1, 2])), lambda G: (G.GF(q)([1, 2]), G.GF(2)([1, 0]))):
        assert outcome(lambda: gt.lagrange_poly(*args(gt))) is outcome(lambda: gj.lagrange_poly(*args(gj)))


# (p, descending coefficients of an irreducible poly over GF(p))
IRREDUCIBLE = [(2, [1, 0, 0, 1, 1]), (2, [1, 1, 1, 1, 1]), (3, [1, 0, 1]), (3, [1, 0, 2, 1]), (5, [1, 0, 2]), (7, [1, 1])]


@pytest.mark.parametrize(["p", "coeffs"], IRREDUCIBLE, ids=[f"{p}-{c}" for p, c in IRREDUCIBLE])
def test_primitive_and_normal_elements_match_jax(p, coeffs):
    ft, fj = gt.Poly(coeffs, field=gt.GF(p)), gj.Poly(coeffs, field=gj.GF(p))
    for name in ("primitive_element", "normal_element"):
        for method in ("min", "max"):
            same_poly(getattr(gt, name)(ft, method), getattr(gj, name)(fj, method))
        assert outcome(lambda: getattr(gt, name)(ft, "mid")) is outcome(lambda: getattr(gj, name)(fj, "mid")) is ValueError
    for name in ("primitive_elements", "normal_elements"):
        a, b = getattr(gt, name)(ft), getattr(gj, name)(fj)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            same_poly(u, v)
    q = p ** (len(coeffs) - 1)
    for e in list(range(0, min(q, 12))) + [q, "x", "x + 1", gt.Poly([1, 1], field=gt.GF(p))]:
        ej = gj.Poly([1, 1], field=gj.GF(p)) if isinstance(e, gt.Poly) else e
        for name in ("is_primitive_element", "is_normal_element"):
            assert getattr(gt, name)(e, ft) == getattr(gj, name)(ej, fj), (name, e)
    for name in ("primitive_element", "normal_element"):
        r = getattr(gt, name)(ft, "random")
        assert getattr(gt, f"is_{name}")(r, ft)


def test_normal_element_of_reducible_poly_raises_like_jax():
    ft, fj = gt.Poly([1, 0, 1], field=gt.GF(2)), gj.Poly([1, 0, 1], field=gj.GF(2))
    assert outcome(lambda: gt.normal_element(ft)) is outcome(lambda: gj.normal_element(fj)) is ValueError


@pytest.mark.parametrize(
    "call",
    [
        lambda G, f: G.primitive_element(7),
        lambda G, f: G.primitive_elements(7),
        lambda G, f: G.normal_element(G.GF(2**4)),
        lambda G, f: G.normal_elements(G.GF(2**4)),
        lambda G, f: G.is_primitive_element("a", f),
        lambda G, f: G.is_normal_element(2.5, f),
    ],
    ids=["primitive_element(7)", "primitive_elements(7)", "normal_element(GF)", "normal_elements(GF)",
         "is_primitive_element('a', f)", "is_normal_element(2.5, f)"],
)
def test_argument_types_raise_type_error(call):
    """The known deviations: the port raises TypeError, as the reference
    does; the JAX package does not, and is not held to it here."""
    f = gt.Poly([1, 0, 0, 1, 1], field=gt.GF(2))
    assert outcome(lambda: call(gt, f)) is TypeError
