"""Polynomial-string elements, seeded ``Random`` and ordering comparisons of
the torch port against the JAX package, and the ``PolyLike`` type alias.

The same inputs, made with numpy from a seed, go through ``galois_tpu`` and
``galois_tpu_torch`` on the CPU; the tolerance is exact equality of the
integers, shapes, result types and exception types. The fields span every
storage kind of the port: one integer per element (GF(2), GF(7), GF(2^3),
GF(2^8), GF(3^5), GF(2^31 - 1)), planar uint16 limbs (the Goldilocks field,
GF(2^100), GF(2^128), BLS12-381's r) and planar base-p digits (GF(3^30),
GF(3^50)).
"""

import functools

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
import galois_tpu.typing as jtyping
import galois_tpu_torch.typing as ttyping

GOLDILOCKS = 2**64 - 2**32 + 1
BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
F128 = "x^128 + x^7 + x^2 + x + 1"

# (id, order, irreducible polynomial or None)
FIELDS = [
    ("GF2", 2, None), ("GF7", 7, None), ("GF8", 2**3, None), ("GF256", 2**8, None), ("GF243", 3**5, None),
    ("M31", 2**31 - 1, None), ("Goldilocks", GOLDILOCKS, None), ("GF2_100", 2**100, None),
    ("GF2_128", 2**128, F128), ("BLS_r", BLS_R, None), ("GF3_30", 3**30, None), ("GF3_50", 3**50, None),
]
FIELD_IDS = [f[0] for f in FIELDS]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


@functools.cache
def _pair(q, f=None):
    """The two packages' classes of one field (cached: a given irreducible
    polynomial is tested at every GF call)."""
    kw = {} if f is None else {"irreducible_poly": f}
    return gj.GF(q, **kw), gt.GF(q, **kw)


def _same(port, ref):
    a, b = np.asarray(port, dtype=object), np.asarray(ref, dtype=object)
    assert a.shape == b.shape and (a == b).all()


# ----------------------------------------------------------------------
# Polynomial strings
# ----------------------------------------------------------------------

def _poly_strings(p, m, n, seed, var="x"):
    """n random polynomials of degree < m over GF(p) as strings in ``var``,
    degrees descending."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coeffs = rng.integers(0, p, m)  # ascending
        terms = []
        for k in reversed(range(m)):
            c = int(coeffs[k])
            if c == 0:
                continue
            c_str = "" if (c == 1 and k) else str(c)
            terms.append(c_str if k == 0 else f"{c_str}{var}" + (f"^{k}" if k > 1 else ""))
        out.append(" + ".join(terms) or "0")
    return out


STRING_FIELDS = [(2**3, 2, 3), (2**8, 2, 8), (3**5, 3, 5), (2**100, 2, 100)]


@pytest.mark.parametrize(["q", "p", "m"], STRING_FIELDS, ids=["GF8", "GF256", "GF243", "GF2_100"])
@pytest.mark.parametrize("var", ["x", "α"])
def test_string_elements_match_jax(q, p, m, var):
    Fj, Ft = _pair(q)
    strs = _poly_strings(p, m, 12, seed=m, var=var)
    for s in strs[:4]:
        assert int(Ft(s)) == int(Fj(s))
    _same(Ft(strs), Fj(strs))
    mixed = [strs[0], 1, [strs[1], 0], [strs[2], p - 1]]
    _same(Ft(mixed[2:]), Fj(mixed[2:]))
    _same(Ft([strs[0], 1, strs[3]]), Fj([strs[0], 1, strs[3]]))
    assert int(Ft(var)) == int(Fj(var)) == p  # the element x


def test_string_examples():
    assert int(gt.GF(2**3)("x^2 + 1")) == 5
    assert int(gt.GF(2**3)("α^2 + α")) == 6
    for q in (2**8, 3**5, 2**100):
        F = gt.GF(q)
        assert int(F("α")) == int(F.primitive_element)


@pytest.mark.parametrize(["q", "p", "m"], STRING_FIELDS, ids=["GF8", "GF256", "GF243", "GF2_100"])
def test_string_assignment_matches_jax(q, p, m):
    Fj, Ft = _pair(q)
    strs = _poly_strings(p, m, 6, seed=100 + m)
    a = np.arange(8) % p
    xj, xt = Fj(a), Ft(a)
    xj[1] = strs[0]
    xt[1] = strs[0]
    xj[2:4] = strs[1:3]
    xt[2:4] = strs[1:3]
    xj[np.array([5, 7])] = [strs[3], 1]
    xt[np.array([5, 7])] = [strs[3], 1]
    _same(xt, xj)


@pytest.mark.parametrize(["q", "bad"], [(2**3, "x^3"), (2**8, "x^8 + 1"), (3**5, "x^5"), (2**100, "x^100")])
def test_out_of_range_strings_raise(q, bad):
    Fj, Ft = _pair(q)
    with pytest.raises(ValueError):
        Fj([bad, 1])
    for value in (bad, [bad, 1], [[1], [bad]]):
        with pytest.raises(ValueError):
            Ft(value)
    x = Ft([0, 1])
    with pytest.raises(ValueError):
        x[0] = bad
    _same(x, [0, 1])  # a refused assignment leaves the array as it was


# ----------------------------------------------------------------------
# Random
# ----------------------------------------------------------------------

RANDOM_CASES = [((), {}), (5, {}), ((3, 4), {}), ((2, 3, 2), {"low": 1}), ((7,), {"low": 2, "high": 5}), ((0,), {})]


@pytest.mark.parametrize(["fid", "q", "f"], FIELDS, ids=FIELD_IDS)
@pytest.mark.parametrize("seed", [0, 9, 2**32 - 1])
def test_random_with_int_seed_matches_jax(fid, q, f, seed):
    Fj, Ft = _pair(q, f)
    for shape, kw in RANDOM_CASES:
        if kw.get("high", 0) > q:
            continue
        xt = Ft.Random(shape, seed=seed, **kw)
        assert type(xt) is Ft and xt.shape == np.empty(shape).shape
        _same(xt, Fj.Random(shape, seed=seed, **kw))


@pytest.mark.parametrize(["fid", "q", "f"], FIELDS, ids=FIELD_IDS)
def test_random_with_numpy_generator_matches_jax(fid, q, f):
    Fj, Ft = _pair(q, f)
    gj_rng, gt_rng = np.random.default_rng(7), np.random.default_rng(7)
    for shape, kw in RANDOM_CASES[1:4]:  # successive draws from one generator
        _same(Ft.Random(shape, seed=gt_rng, **kw), Fj.Random(shape, seed=gj_rng, **kw))
    assert gt_rng.integers(0, 2**62) == gj_rng.integers(0, 2**62)  # both generators advanced alike


def test_random_seed_and_generator_exclusive():
    import torch

    F = gt.GF(7)
    g = torch.Generator().manual_seed(1)
    x = F.Random(10, generator=g)
    assert x.shape == (10,) and (np.asarray(x) < 7).all()
    with pytest.raises(ValueError):
        F.Random(10, seed=1, generator=g)


def test_random_determinant_loop_ends():
    """The JAX suite draws Random((2, 2), seed=9) over GF(2) until the
    matrix is invertible: with the JAX package's integers it is."""
    A = gt.GF2.Random((2, 2), seed=9)
    assert int(np.linalg.det(A)) == 1
    _same(A, gj.GF2.Random((2, 2), seed=9))


# ----------------------------------------------------------------------
# Ordering comparisons
# ----------------------------------------------------------------------

OPS = ["__lt__", "__le__", "__gt__", "__ge__"]


def _compare_inputs(q, seed):
    """(3, 4) and (4,) int reprs with many equal leading words: draws near
    a few centres, so that the comparisons reach the low words."""
    rng = np.random.default_rng(seed)
    centres = [q // 3, q // 2, q - 1 - q // 5]
    span = min(q // 7, 2**40)

    def draw(shape):
        n = int(np.prod(shape))
        c = [centres[i] for i in rng.integers(0, 3, n)]
        d = [int(v) for v in rng.integers(0, span + 1, n)]
        return np.array([min(q - 1, a + b) for a, b in zip(c, d)], dtype=object).reshape(shape)

    a, b = draw((3, 4)), draw((4,))
    a[0, :] = b  # equal elements
    return a, b


@pytest.mark.parametrize(["fid", "q", "f"], FIELDS, ids=FIELD_IDS)
@pytest.mark.parametrize("op", OPS)
def test_comparisons_match_jax(fid, q, f, op):
    Fj, Ft = _pair(q, f)
    a, b = _compare_inputs(q, seed=len(fid))
    aj, bj, at, bt = Fj(a), Fj(b), Ft(a), Ft(b)
    for (xt, yt), (xj, yj) in [((at, bt), (aj, bj)), ((bt, at), (bj, aj)), ((at[1, 2], at), (aj[1, 2], aj)),
                               ((at, at[2, 1]), (aj, aj[2, 1])), ((at[0, 1], bt[3]), (aj[0, 1], bj[3]))]:
        rt, rj = getattr(xt, op)(yt), getattr(xj, op)(yj)
        assert type(rt) is type(rj) and np.asarray(rt).dtype == np.asarray(rj).dtype
        assert np.array_equal(rt, rj)
    ints = int(b[1])
    assert np.array_equal(getattr(at, op)(ints), getattr(aj, op)(ints))


@pytest.mark.parametrize(["fid", "q", "f"], FIELDS, ids=FIELD_IDS)
def test_mask_indexing_and_where_match_jax(fid, q, f):
    Fj, Ft = _pair(q, f)
    a, b = _compare_inputs(q, seed=99)
    aj, at = Fj(a), Ft(a)
    pivot = int(b[2])
    _same(at[at > pivot], aj[aj > pivot])
    _same(at[at <= Ft(pivot)], aj[aj <= Fj(pivot)])
    for rt, rj in zip(np.where(at >= pivot), np.where(aj >= pivot)):
        assert np.array_equal(rt, rj)


def test_unsupported_comparisons_are_refused():
    F = gt.GF(7)
    x = F([1, 2, 3])
    for other in (1.5, "not a poly", gt.GF(11)([1, 2, 3])):
        with pytest.raises(TypeError):
            x < other
    with pytest.raises(TypeError):
        x >= 7  # out of range: no element to compare with
    assert x._compare(1.5, lambda a, b: a < b) is NotImplemented


# ----------------------------------------------------------------------
# typing
# ----------------------------------------------------------------------

def test_typing_names_match_jax():
    assert set(ttyping.__all__) == set(jtyping.__all__)
    assert "PolyLike" in ttyping.__all__ and hasattr(ttyping, "PolyLike")
    assert str in ttyping.PolyLike.__args__ and str in ttyping.ElementLike.__args__
