"""GF(2^m), m > 32, on planar limbs in the torch port against the JAX package.

The fields GF(2^64), GF(2^100), GF(2^128) with GCM's modulus and GF(2^233)
with NIST B-233's are built in both packages; the same seeded NumPy inputs
go through the port's arithmetic (kernel K14's plain versions on the CPU)
and through the JAX package's host field in Python ints, and for GF(2^100)
through its device ops too. Integers must be equal. K14's plain product,
square and power are also held against a carry-less product in Python
ints written here, and the kernel's reduction, folding through its host
inputs (the sparse terms and the byte table), against the plain product.
"""

import functools

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field as jax_host_field
from galois_tpu_torch.ops._limb_binary import (
    DENSE_MODULI,
    _from_words,
    _mulmod_words,
    _to_words,
    fold_inputs,
    gf2_limb_multiply,
    gf2_limb_multiply_plain,
    gf2_limb_power,
    gf2_limb_power_plain,
    gf2_limb_square,
    gf2_limb_square_plain,
)

FIELDS = [
    (2**64, None),
    (2**100, None),
    (2**128, "x^128 + x^7 + x^2 + x + 1"),
    (2**233, "x^233 + x^74 + 1"),
]
IDS = ["GF(2^64)", "GF(2^100)", "GF(2^128)", "GF(2^233)"]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """The plain versions on the CPU, with one torch thread: the tensors hold
    a few elements, and other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with gt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _fields(q, f):
    """Both packages' field, built once: a given irreducible polynomial is
    tested at every construction (some 5 s for B-233's in each package)."""
    kw = {} if f is None else {"irreducible_poly": f}
    return gt.GF(q, **kw), gj.GF(q, **kw)


def _ints(q, n, seed, low=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % q for row in words]
    return np.array([max(v, low) for v in vals], dtype=object)


def _clmul_mod(a: int, b: int, m: int, f: int) -> int:
    c = 0
    for i in range(m):
        if (b >> i) & 1:
            c ^= a << i
    for i in range(2 * m - 2, m - 1, -1):
        if (c >> i) & 1:
            c ^= f << (i - m)
    return c


def _eq(a, b):
    return np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


@pytest.mark.parametrize("q,f", FIELDS, ids=IDS)
def test_field_matches_jax(q, f):
    Ft, Fj = _fields(q, f)
    mt, mj = Ft._meta, Fj._meta
    assert (mt.storage, mt.storage_width, mt.irreducible_poly_int, mt.primitive_element_int) == (
        mj.storage, mj.storage_width, mj.irreducible_poly_int, mj.primitive_element_int,
    )
    assert Ft.dtypes == Fj.dtypes and Ft.ufunc_modes == Fj.ufunc_modes
    assert str(Ft.irreducible_poly) == str(Fj.irreducible_poly)
    assert Ft.properties == Fj.properties


@pytest.mark.parametrize("q,f", FIELDS, ids=IDS)
def test_elementwise_matches_jax(q, f):
    Ft, Fj = _fields(q, f)
    hf = jax_host_field(Fj._meta)
    xs, ys = _ints(q, 6, 1), _ints(q, 6, 2, low=1)
    x, y = Ft(xs), Ft(ys)
    pairs = list(zip(xs, ys))
    assert _eq(x + y, [hf.add(a, b) for a, b in pairs])
    assert _eq(x - y, [hf.subtract(a, b) for a, b in pairs])
    assert _eq(-x, [hf.negative(a) for a in xs])
    assert _eq(x * y, [hf.multiply(a, b) for a, b in pairs])
    assert _eq(x / y, [hf.divide(a, b) for a, b in pairs])
    assert _eq(np.reciprocal(y), [hf.reciprocal(b) for b in ys])
    assert _eq(y**-3, [hf.power(hf.reciprocal(b), 3) for b in ys])
    assert _eq(x**5, [hf.power(a, 5) for a in xs])
    e = np.array([0, 1, 2, 7, 2**40 + 3, 12345], dtype=np.int64)
    assert _eq(x**e, [hf.power(a, int(k)) for a, k in zip(xs, e)])
    assert _eq(y[1:] ** -e[1:], [hf.power(hf.reciprocal(b), int(k)) for b, k in zip(ys[1:], e[1:])])
    assert _eq(np.sqrt(x) * np.sqrt(x), xs)  # the square root is unique in characteristic 2
    assert (x == x).all() and not (x == y).any()
    assert _eq(x * 3, xs) and _eq(2 * x, np.zeros(6, dtype=object))  # multiply by an int: repeated addition
    with pytest.raises(ZeroDivisionError):
        x / Ft.Zeros(6)


@pytest.mark.parametrize("q,f", FIELDS, ids=IDS)
def test_arrays_match_jax(q, f):
    Ft, Fj = _fields(q, f)
    xs = _ints(q, 6, 3).reshape(2, 3)
    xt, xj = Ft(xs), Fj(xs)
    assert str(xt) == str(xj) and repr(xt) == repr(xj)
    assert str(xt[1, 2]) == str(xj[1, 2]) and repr(xt[0]) == repr(xj[0])
    back = Ft.from_numpy(np.asarray(xj))
    assert _eq(back, xs) and back.shape == (2, 3)
    assert _eq(xt.T, xs.T) and _eq(xt.reshape(3, 2), xs.reshape(3, 2)) and _eq(xt[:, ::2], xs[:, ::2])
    assert _eq(np.concatenate([xt, xt]), np.concatenate([xs, xs]))
    assert _eq(Ft.Ones(3), [1, 1, 1]) and _eq(Ft.Identity(2), np.eye(2, dtype=np.int64))
    m = Ft.degree
    assert _eq(xt.vector(), [[[(int(v) >> (m - 1 - i)) & 1 for i in range(m)] for v in row] for row in xs])
    total = 0
    for v in xs.reshape(-1):
        total ^= int(v)
    assert int(np.sum(xt)) == total
    hf = jax_host_field(Fj._meta)

    def trace(v):
        acc, y = 0, int(v)
        for _ in range(m):
            acc, y = hf.add(acc, y), hf.multiply(y, y)
        return acc

    assert _eq(xt.field_trace(), [[trace(v) for v in row] for row in xs])
    r = Ft.Random((4, 5), seed=1)
    assert r.shape == (4, 5) and all(0 <= int(v) < q for v in np.asarray(r).reshape(-1))


def test_device_ops_match_jax():
    """The JAX package's own device arrays (its LimbBinaryOps scans)."""
    q = 2**100
    Ft, Fj = _fields(q, None)
    xs, ys = _ints(q, 8, 4), _ints(q, 8, 5, low=1)
    assert _eq(Ft(xs) * Ft(ys), Fj(xs) * Fj(ys))
    assert _eq(Ft(xs) / Ft(ys), Fj(xs) / Fj(ys))


@pytest.mark.parametrize("q,f", [FIELDS[1], FIELDS[3]], ids=[IDS[1], IDS[3]])
def test_poly_and_linalg_match_jax(q, f):
    Ft, Fj = _fields(q, f)
    a, b = _ints(q, 7, 6), _ints(q, 3, 7, low=1)
    pt, pj = gt.Poly(Ft(a)), gj.Poly(Fj(a))
    gt_b, gj_b = gt.Poly(Ft(b)), gj.Poly(Fj(b))
    assert str(pt * gt_b) == str(pj * gj_b)
    qt, rt = divmod(pt, gt_b)
    qj, rj = divmod(pj, gj_b)
    assert str(qt) == str(qj) and str(rt) == str(rj)
    pts = _ints(q, 4, 8)
    hf = jax_host_field(Fj._meta)
    horner = []
    for x in pts:
        acc = 0
        for c in a:
            acc = hf.add(hf.multiply(acc, int(x)), int(c))
        horner.append(acc)
    assert _eq(pt(Ft(pts)), horner)
    A, B = _ints(q, 9, 9).reshape(3, 3), _ints(q, 3, 10)
    At = Ft(A)
    prod = [[0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            for k in range(3):
                prod[i][j] = hf.add(prod[i][j], hf.multiply(int(A[i, k]), int(A[k, j])))
    assert _eq(At @ At, prod)
    assert _eq(np.linalg.inv(At), np.linalg.inv(Fj(A)))
    assert _eq(np.linalg.solve(At, Ft(B)), np.linalg.solve(Fj(A), Fj(B)))
    assert int(np.linalg.det(At)) == int(np.linalg.det(Fj(A)))


@pytest.mark.parametrize("q,f", FIELDS, ids=IDS)
def test_k14_plain_against_python_ints(q, f):
    """K14's plain product (the kernel's bit-serial form), square and power,
    through the wrappers on CPU tensors, against a carry-less product in
    Python ints; a one-element operand broadcasts."""
    Ft, _ = _fields(q, f)
    m, fi = Ft._meta.degree, Ft._meta.irreducible_poly_int
    xs, ys = _ints(q, 5, 11), _ints(q, 5, 12)
    x, y = Ft(xs)._data, Ft(ys)._data
    prod = gf2_limb_multiply(x, y, m, fi)
    assert _eq(Ft._view(prod), [_clmul_mod(int(a), int(b), m, fi) for a, b in zip(xs, ys)])
    # the many-element form, the kernel's bit-serial steps on 64-bit words, taken directly
    W = -(-m // 64)
    words = _from_words(_mulmod_words(_to_words(x, W), _to_words(y, W), m, fi), x.shape[0])
    assert _eq(Ft._view(words), Ft._view(prod))
    one = Ft(ys[:1])._data[:, :1].reshape(-1)  # a 0-D element: (L,)
    assert _eq(Ft._view(gf2_limb_multiply_plain(x, one, m, fi)), [_clmul_mod(int(a), int(ys[0]), m, fi) for a in xs])
    assert _eq(Ft._view(gf2_limb_square(x, m, fi)), [_clmul_mod(int(a), int(a), m, fi) for a in xs])
    assert _eq(Ft._view(gf2_limb_square_plain(x, m, fi)), Ft._view(gf2_limb_multiply_plain(x, x, m, fi)))

    def py_pow(a, e):
        r = 1
        for bit in bin(e)[2:]:
            r = _clmul_mod(r, r, m, fi)
            if bit == "1":
                r = _clmul_mod(r, a, m, fi)
        return r

    for e in (0, 1, 5, 2**m - 2, 2 ** (m - 1)):
        assert _eq(Ft._view(gf2_limb_power(x, e, m, fi)), [py_pow(int(a), e) for a in xs]), e
    import torch

    ew = torch.tensor([0, 3, 2**61 + 1, 77, 1], dtype=torch.int64)
    got = Ft._view(gf2_limb_power_plain(x, [ew], m, fi, 62))
    assert _eq(got, [py_pow(int(a), int(e)) for a, e in zip(xs, ew.tolist())])


@pytest.mark.parametrize("q,f", FIELDS[:2], ids=IDS[:2])
def test_log_matches_jax(q, f):
    """GF(2^m > 32) takes the host Pohlig-Hellman in both packages."""
    Ft, Fj = _fields(q, f)
    xs = _ints(q, 3, 13, low=1)
    assert _eq(Ft(xs).log(), Fj(xs).log())


# (m, f): GCM's and B-233's sparse moduli; the dense irreducible ones, which only the byte table reduces
FOLD_MODULI = [(128, 2**128 + 2**7 + 2**2 + 2 + 1), (233, 2**233 + 2**74 + 1), *DENSE_MODULI]


def _fold_like_kernel(c: int, m: int, f: int, by_terms: bool) -> int:
    """csrc/gf2_limb.cu's reduce() in Python ints on fold_inputs' arrays:
    c (degree <= 2m - 2) in the frame shifted by s; two passes of the terms'
    folds, or the byte table top down; then back out of the frame."""
    s, terms, table = fold_inputs(m, f)
    N = (m + s) // 32
    low = (1 << (32 * N)) - 1
    c <<= s
    if by_terms:
        for _ in range(2):
            h, c = c >> (32 * N), c & low
            for q, r in terms:
                c ^= h << (32 * q + r)
        assert c >> (32 * N) == 0  # two passes leave nothing above x^m
    else:
        for i in reversed(range(4 * N)):
            b = (c >> (32 * N + 8 * i)) & 0xFF
            row = sum(int(w) << (32 * j) for j, w in enumerate(table[b]))
            c ^= row << (8 * i)
        c &= low
    return c >> s


@pytest.mark.parametrize(["m", "fi"], FOLD_MODULI, ids=["GCM", "B-233", "dense-64", "dense-128", "dense-129"])
def test_k14_fold_inputs_reduce_like_plain(m, fi):
    """The kernel's reduction inputs: the frame shift, the sparse terms (None
    for a dense f) and the byte table (every f); products and squares
    folded through them equal the plain versions'."""
    s, terms, table = fold_inputs(m, fi)
    N = 2 * -(-m // 64)
    dense = bin(fi).count("1") > (m + 1) // 2
    assert s == 32 * N - m and table.shape == (256, N) and table.dtype == np.uint32
    assert (terms is None) == dense
    L = -(-m // 16)
    xs = [int(v) % 2**m for v in _ints(2**m, 24, m)]
    ys = [int(v) % 2**m for v in _ints(2**m, 24, m + 1)]
    xs[0], ys[1] = 0, 2**m - 1

    def limbs(vals):
        arr = np.array([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(L)], dtype=np.int64)
        return torch.from_numpy(arr).to(torch.int32).to(torch.int16).view(torch.uint16)

    def ints(t):
        a = (t.view(torch.int16).to(torch.int64) & 0xFFFF).numpy()
        return [sum(int(a[l, e]) << (16 * l) for l in range(L)) for e in range(a.shape[1])]

    def clmul(a, b):
        c = 0
        for i in range(m):
            if (b >> i) & 1:
                c ^= a << i
        return c

    prod = ints(gf2_limb_multiply_plain(limbs(xs), limbs(ys), m, fi))
    sq = ints(gf2_limb_square_plain(limbs(xs), m, fi))
    for by_terms in ([True, False] if terms else [False]):
        assert [_fold_like_kernel(clmul(a, b), m, fi, by_terms) for a, b in zip(xs, ys)] == prod
        assert [_fold_like_kernel(clmul(a, a), m, fi, by_terms) for a in xs] == sq
