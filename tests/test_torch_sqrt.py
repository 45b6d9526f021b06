"""Square roots, squares, trace, norm and the element constructors and
collections of the torch port against the JAX package.

``sqrt`` (and ``np.sqrt``), ``is_square``, ``field_trace``, ``field_norm``,
``additive_order``, ``vector``/``Vector``, ``Range``, ``Vandermonde``, the
metaclass collections (``elements``, ``units``, ``primitive_elements``,
``squares``, ``non_squares``, ``normal_element(s)``), ``is_primitive_poly``,
``properties`` and the abstract base ``Array``, over the fields of the
port's CPU probe and GF(2), GF(2^32 - 5), GF(3 * 2^30 + 1) (Tonelli-Shanks
with S = 30) and the Goldilocks field (Tonelli-Shanks on limbs, S = 32),
in both modes where a field has both. The same inputs, made with numpy
from a seed, go through ``galois_tpu`` and ``galois_tpu_torch`` on the CPU;
the tolerance is exact integer equality of ``np.asarray`` results, and the
exception types must agree. The square-root tables of
``tests/fields/test_sqrt.py`` (Sage-derived) are held against the port too.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu_torch.fields import _factory as torch_factory
from tests.fields.test_sqrt import CASES as SQRT_LUTS

M31 = 2**31 - 1
NTT_P = 3 * 2**30 + 1
GOLDILOCKS = 2**64 - 2**32 + 1

# (id, order): the CPU probe's ten fields, then GF(2), a large prime with
# q = 1 mod 8 (Tonelli-Shanks, S = 30) and the Goldilocks field (limbs)
ORDERS = [
    ("GF16", 2**4), ("GF256", 2**8), ("GF8192", 2**13), ("GF65536", 2**16), ("GF243", 3**5),
    ("GF125", 5**3), ("GF7", 7), ("GF65537", 65537), ("M31", M31), ("P32", 2**32 - 5),
    ("GF2", 2), ("NTT", NTT_P), ("Goldilocks", GOLDILOCKS),
]
LOOKUP = {"GF16", "GF256", "GF8192", "GF65536", "GF243", "GF125", "GF7", "GF65537"}
CASES = [(fid, q, "jit-calculate") for fid, q in ORDERS] + [(fid, q, "jit-lookup") for fid, q in ORDERS if fid in LOOKUP]
CASE_IDS = [f"{fid}-{mode[4:]}" for fid, _, mode in CASES]
N = 64


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


def fields(q, mode="jit-calculate"):
    return gt.GF(q, compile=mode), gj.GF(q, compile=mode)


def ints(q, shape, rng, low=0):
    """Uniform int reprs in [low, q): int64, or object ints above 2^62."""
    if q <= 2**62:
        return rng.integers(low, q, shape, dtype=np.int64)
    hi, lo = (rng.integers(0, 2**32, shape).astype(object) for _ in range(2))
    return (hi * 2**32 + lo) % (q - low) + low


def same(a, b):
    """Exact equality at the public boundary: the integers, and the class
    name and dtype of field arrays."""
    arrays = (gt.FieldArray, gj.FieldArray)
    if isinstance(a, arrays) or isinstance(b, arrays):
        assert isinstance(a, arrays) and isinstance(b, arrays) and type(a).name == type(b).name
        assert a.shape == b.shape and a.dtype == b.dtype
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tolist() == b.tolist()


def outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001  (the type is compared)
        return type(e)


@pytest.mark.parametrize(["fid", "q", "mode"], CASES, ids=CASE_IDS)
def test_sqrt_of_squares_matches_jax(fid, q, mode):
    """np.sqrt and .sqrt of random squares (0 among them): the JAX package's
    canonical roots; r * r == x and r <= -r as integers."""
    F, G = fields(q, mode)
    y = ints(q, N, np.random.default_rng(q % 1000 + 1))
    y[0] = 0
    xt, xj = F(y) * F(y), G(y) * G(y)
    same(xt, xj)
    rt = np.sqrt(xt)
    same(rt, np.sqrt(xj))
    same(xt.sqrt(), rt)
    assert np.array_equal(np.asarray(rt * rt), np.asarray(xt))
    r, n = np.asarray(rt).astype(object), np.asarray(-rt).astype(object)
    assert all(a <= b for a, b in zip(r, n))


@pytest.mark.parametrize(["fid", "q", "mode"], CASES, ids=CASE_IDS)
def test_is_square_matches_jax(fid, q, mode):
    """Euler's criterion over random elements (0 included), 1-D and 0-D;
    sqrt of an array holding a non-square raises ArithmeticError in both."""
    F, G = fields(q, mode)
    x = ints(q, N, np.random.default_rng(q % 1000 + 2))
    x[1] = 0
    sq = F(x).is_square()
    same(sq, G(x).is_square())
    for v in (int(x[1]), int(x[2])):
        a, b = F(v).is_square(), G(v).is_square()
        assert type(a) is type(b) and a == b
    if not sq.all():
        assert outcome(lambda: F(x).sqrt()) is outcome(lambda: G(x).sqrt()) is ArithmeticError


@pytest.mark.parametrize(["fid", "q", "mode"], CASES, ids=CASE_IDS)
def test_trace_norm_additive_order_match_jax(fid, q, mode):
    F, G = fields(q, mode)
    x = ints(q, (4, 8), np.random.default_rng(q % 1000 + 3))
    x[0, 0] = 0
    for name in ("field_trace", "field_norm"):
        same(getattr(F(x), name)(), getattr(G(x), name)())
    a, b = F(x).additive_order(), G(x).additive_order()
    same(a, b)
    a, b = F(0).additive_order(), G(0).additive_order()
    assert type(a) is type(b) and a == b


@pytest.mark.parametrize(["fid", "q"], ORDERS, ids=[o[0] for o in ORDERS])
def test_vector_and_Vector_match_jax(fid, q):
    F, G = fields(q)
    x = ints(q, (3, 5), np.random.default_rng(q % 1000 + 4))
    vt, vj = F(x).vector(), G(x).vector()
    same(vt, vj)
    same(F.Vector(vt), G.Vector(vj))
    same(F.Vector(np.asarray(vj).tolist()), G.Vector(np.asarray(vj).tolist()))
    same(F(int(x[0, 0])).vector(), G(int(x[0, 0])).vector())
    assert outcome(lambda: F.Vector([[1] * (F.degree + 1)])) is outcome(lambda: G.Vector([[1] * (G.degree + 1)]))


@pytest.mark.parametrize(["fid", "q"], ORDERS, ids=[o[0] for o in ORDERS])
def test_range_and_vandermonde_match_jax(fid, q):
    F, G = fields(q)
    for args in ((0, min(q, 40)), (1, min(q, 30), 3), (q - 5 if q > 5 else 0, q)):
        same(F.Range(*args), G.Range(*args))
    for dtype in (np.int64, np.uint8):  # the limb field takes neither
        a = outcome(lambda: F.Range(0, min(q, 4), dtype=dtype))
        b = outcome(lambda: G.Range(0, min(q, 4), dtype=dtype))
        if isinstance(a, type):
            assert a is b is TypeError
        else:
            same(a, b)
    for args in ((-1, 3), (0, q + 1)):
        assert outcome(lambda: F.Range(*args)) is outcome(lambda: G.Range(*args)) is ValueError
    a = int(ints(q, 1, np.random.default_rng(q % 1000 + 5), low=1)[0])
    same(F.Vandermonde(a, 4, 5), G.Vandermonde(a, 4, 5))
    same(F.Vandermonde(F(0), 3, 3), G.Vandermonde(G(0), 3, 3))
    assert outcome(lambda: F.Vandermonde([a], 2, 2)) is outcome(lambda: G.Vandermonde([a], 2, 2)) is ValueError


SMALL = [("GF2", 2), ("GF7", 7), ("GF16", 2**4), ("GF256", 2**8), ("GF243", 3**5), ("GF125", 5**3), ("GF289", 17**2), ("GF65537", 65537)]


@pytest.mark.parametrize(["fid", "q"], SMALL, ids=[s[0] for s in SMALL])
def test_collections_and_properties_match_jax(fid, q):
    F, G = fields(q)
    for name in ("elements", "units", "primitive_elements", "squares", "non_squares"):
        same(getattr(F, name), getattr(G, name))
    for name in ("is_primitive_poly", "properties"):
        assert getattr(F, name) == getattr(G, name)
    if q <= 2**8:
        same(F.normal_element, G.normal_element)
        same(F.normal_elements, G.normal_elements)


@pytest.mark.parametrize("mode", ["jit-calculate", "jit-lookup"])
def test_collections_in_lookup_mode(mode):
    F, G = fields(3**5, mode)
    for name in ("squares", "non_squares", "primitive_elements"):
        same(getattr(F, name), getattr(G, name))


def test_collections_of_large_fields():
    """The collections that stay cheap for large orders: Range-based ones
    of the limb field, the primitive polynomial test, the properties."""
    for q in (GOLDILOCKS, M31, 2**32 - 5):
        F, G = fields(q)
        assert F.is_primitive_poly == G.is_primitive_poly
        assert F.properties == G.properties
    F, G = fields(GOLDILOCKS)
    same(F.Range(GOLDILOCKS - 3, GOLDILOCKS), G.Range(GOLDILOCKS - 3, GOLDILOCKS))


def test_array_is_the_abstract_base():
    F, G = fields(7)
    assert isinstance(F(3), gt.Array) and issubclass(F, gt.Array) and issubclass(gt.FieldArray, gt.Array)
    assert isinstance(G(3), gj.Array) and issubclass(G, gj.Array)
    assert not isinstance(3, gt.Array)
    assert outcome(lambda: gt.Array(3)) is outcome(lambda: gj.Array(3)) is NotImplementedError


@pytest.mark.parametrize(["order", "x", "expect"], SQRT_LUTS, ids=[str(c[0]) for c in SQRT_LUTS])
def test_sqrt_luts(order, x, expect):
    """The Sage-derived tables of tests/fields/test_sqrt.py, in both modes
    where the field has both."""
    for mode in {"jit-calculate", "jit-lookup"} & set(gt.GF(order).ufunc_modes):
        F = gt.GF(order, compile=mode)
        try:
            y = np.sqrt(F(x))
            assert isinstance(y, F)
            assert np.asarray(y, dtype=np.int64).tolist() == expect, (order, mode)
        finally:
            F.compile("auto")
