"""Reed-Solomon and BCH codes of the torch port against the JAX package.

Construction (G, H, g(x), h(x), roots, alpha), encode, detect and the
batched decode, with errors, erasures, shortened words, 1-D input,
``output="codeword"``, ``errors=True`` and rows that fail with -1, for
RS(15,11), RS(31,25) with c = 3, RS(255,223), BCH(15,7), BCH(31,21),
BCH(511,493), BCH(8,4) over GF(3) (syndromes in GF(3^2), the digit-plane
matmul) and a non-systematic RS(15,9). The words are made with numpy from a
seed and fed to both packages (``FieldArray.from_numpy`` on this side); the
tolerance is exact integer equality. Each code builds at most three JAX
decoders (one per received length and erasure flag): about 15 in all.
"""

import functools

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.ops import _kernels

CODES = {
    "rs15": lambda g: g.ReedSolomon(15, 11),
    "rs31_c3": lambda g: g.ReedSolomon(31, 25, c=3),
    "rs255": lambda g: g.ReedSolomon(255, 223),
    "bch15": lambda g: g.BCH(15, 7),
    "bch31": lambda g: g.BCH(31, 21),
    "bch511": lambda g: g.BCH(511, 493),
    "bch8_gf3": lambda g: g.BCH(8, 4, field=g.GF(3)),
    "rs15_nonsys": lambda g: g.ReedSolomon(15, 9, systematic=False),
}
BATCH = {"rs255": 8, "bch511": 4}  # the rest: 6 rows


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


@functools.lru_cache(maxsize=None)
def _pair(name):
    with gt.default_device("cpu"):
        return CODES[name](gt), CODES[name](gj)


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _words(code, rows: int, seed: int, ns=None):
    """Messages (rows, ks) and their codewords (rows, ns) as int64 numpy,
    encoded by the JAX package."""
    ns = code.n if ns is None else ns
    ks = code.k - (code.n - ns)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, code.field.order, (rows, ks))
    return msg, np.asarray(code.encode(code.field(msg))).astype(np.int64)


def _corrupt(code, words, counts, seed: int):
    """Add a nonzero field element at ``counts[i]`` random positions of row
    i (XOR in characteristic 2; the odd fields here are prime)."""
    rng = np.random.default_rng(seed)
    out = words.copy()
    q = code.field.order
    for i, e in enumerate(counts):
        pos = rng.choice(words.shape[1], size=e, replace=False)
        noise = rng.integers(1, q, e)
        out[i, pos] = out[i, pos] ^ noise if q % 2 == 0 else (out[i, pos] + noise) % q
    return out


def _counts(code, rows: int):
    """Per-row error counts: 0, 1, t, then rows beyond the capability."""
    t = code.t
    base = [0, min(1, t), t]
    return (base + [2 * t + 1, code.d + 1, t + 1, 2 * t + 2, 3 * t])[:rows]


@pytest.mark.parametrize("name", list(CODES))
def test_construction_matches_jax(name):
    ct, cj = _pair(name)
    assert (ct.n, ct.k, ct.d, ct.t) == (cj.n, cj.k, cj.d, cj.t)
    assert (ct.is_systematic, ct.is_primitive, ct.is_narrow_sense, ct.c) == (
        cj.is_systematic, cj.is_primitive, cj.is_narrow_sense, cj.c,
    )
    assert ct.field._meta.irreducible_poly_int == cj.field._meta.irreducible_poly_int
    for attr in ("G", "H", "roots", "alpha"):
        _same(getattr(ct, attr), getattr(cj, attr))
    for attr in ("generator_poly", "parity_check_poly"):
        pt, pj = getattr(ct, attr), getattr(cj, attr)
        assert str(pt) == str(pj) and int(pt) == int(pj)
    if hasattr(cj, "extension_field"):
        assert ct.extension_field._meta.irreducible_poly_int == cj.extension_field._meta.irreducible_poly_int
        assert ct.extension_field.order == cj.extension_field.order
    assert str(ct) == str(cj)


@pytest.mark.parametrize("name", list(CODES))
def test_encode_and_detect_match_jax(name):
    ct, cj = _pair(name)
    rows = BATCH.get(name, 6)
    msg, cw = _words(cj, rows, seed=len(name))
    _same(ct.encode(ct.field.from_numpy(msg)), cj.encode(cj.field(msg)))
    _same(ct.encode(ct.field.from_numpy(msg[0])), cj.encode(cj.field(msg[0])))  # 1-D
    if cj.is_systematic:
        _same(ct.encode(ct.field.from_numpy(msg), output="parity"), cj.encode(cj.field(msg), output="parity"))
        short = msg[:, 2:]  # shortened: the leading symbols elided
        _same(ct.encode(ct.field.from_numpy(short)), cj.encode(cj.field(short)))
    else:
        with pytest.raises(ValueError):
            ct.encode(ct.field.from_numpy(msg), output="parity")
    bad = _corrupt(cj, cw, [0, 1] * (rows // 2), seed=3)
    got = ct.detect(ct.field.from_numpy(bad))
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert np.array_equal(got, cj.detect(cj.field(bad)))
    assert ct.detect(ct.field.from_numpy(bad[1])) is cj.detect(cj.field(bad[1])) is True
    if cj.is_systematic:
        assert np.array_equal(ct.detect(ct.field.from_numpy(bad[:, 2:])), cj.detect(cj.field(bad[:, 2:])))


@pytest.mark.parametrize("name", list(CODES))
def test_decode_errors_match_jax(name):
    ct, cj = _pair(name)
    rows = BATCH.get(name, 6)
    msg, cw = _words(cj, rows, seed=7 + len(name))
    counts = _counts(cj, rows)
    rx = _corrupt(cj, cw, counts, seed=11)
    xt, xj = ct.field.from_numpy(rx), cj.field(rx)
    dt, et = ct.decode(xt, errors=True)
    dj, ej = cj.decode(xj, errors=True)
    _same(dt, dj)
    assert et.dtype == np.int64 and np.array_equal(et, ej)
    # within the capability: the message and the count; beyond it: -1, or
    # a codeword (a legal miscorrection)
    ok = np.asarray(counts) <= cj.t
    assert np.array_equal(np.asarray(dt)[ok], msg[ok]) and np.array_equal(et[ok], np.asarray(counts)[ok])
    assert (et == -1).any()
    _same(ct.decode(xt), cj.decode(xj))
    cw_t = ct.decode(xt, output="codeword")
    _same(cw_t, cj.decode(xj, output="codeword"))
    assert not ct.detect(cw_t[et >= 0]).any()
    out_t, e_t = ct.decode(xt[1], errors=True)  # 1-D: row 1 of the JAX batch (no second JAX decoder)
    _same(out_t, dj[1])
    assert isinstance(e_t, np.int64) and e_t == ej[1]


@pytest.mark.parametrize("name", ["rs15", "rs31_c3", "rs255", "bch31", "bch8_gf3"])
def test_decode_erasures_match_jax(name):
    ct, cj = _pair(name)
    rows = BATCH.get(name, 6)
    _, cw = _words(cj, rows, seed=13)
    rng = np.random.default_rng(17)
    era = np.zeros(cw.shape, dtype=bool)
    counts = []
    for i in range(rows):  # 2e + f around the capability d - 1
        f = int(rng.integers(0, cj.d)) if i else 0
        era[i, rng.choice(cj.n, size=f, replace=False)] = True
        counts.append(max(0, (cj.d - 1 - f) // 2 + (i % 3 == 2)))
    rx = _corrupt(cj, cw, counts, seed=19)
    rx = np.where(era, (rx + 1) % cj.field.order, rx)  # garbage under the erasures
    dt, et = ct.decode(ct.field.from_numpy(rx), erasures=era, errors=True)
    dj, ej = cj.decode(cj.field(rx), erasures=era, errors=True)
    _same(dt, dj)
    assert np.array_equal(et, ej) and (et >= 0).any()
    _same(
        ct.decode(ct.field.from_numpy(rx), erasures=era, output="codeword"),
        cj.decode(cj.field(rx), erasures=era, output="codeword"),
    )
    with pytest.raises(ValueError):
        ct.decode(ct.field.from_numpy(rx), erasures=era.astype(np.int64))


@pytest.mark.parametrize("name", ["rs15", "bch15"])
def test_decode_shortened_matches_jax(name):
    ct, cj = _pair(name)
    ns = cj.n - 3
    msg, cw = _words(cj, 6, seed=23, ns=ns)
    counts = _counts(cj, 6)
    rx = _corrupt(cj, cw, counts, seed=29)
    dt, et = ct.decode(ct.field.from_numpy(rx), errors=True)
    dj, ej = cj.decode(cj.field(rx), errors=True)
    _same(dt, dj)
    assert np.array_equal(et, ej)
    assert np.array_equal(np.asarray(dt)[:3], msg[:3])


def test_generator_parity_check_conversions_match_jax():
    ct, cj = _pair("rs15")
    Ht, Hj = gt.generator_to_parity_check_matrix(ct.G), gj.generator_to_parity_check_matrix(cj.G)
    _same(Ht, Hj)
    _same(gt.parity_check_to_generator_matrix(Ht), gj.parity_check_to_generator_matrix(Hj))
    _same(gt.parity_check_to_generator_matrix(Ht), ct.G)
    with pytest.raises(ValueError):
        gt.generator_to_parity_check_matrix(Ht)


def test_decoders_route_products_to_k8_and_k7(monkeypatch):
    """GF(2^8) decoding multiplies through K8's wrapper and GF(2^9) decoding
    (BCH(511)) through K7's: the card launches the kernels where this runs
    their plain versions."""
    calls = []
    for name in ("gf2m_multiply_swar", "gf2m_multiply"):
        real = getattr(_kernels, name)
        monkeypatch.setattr(_kernels, name, lambda *a, real=real, name=name: (calls.append(name), real(*a))[1])
    for code_name, kernel in (("rs255", "gf2m_multiply_swar"), ("bch511", "gf2m_multiply")):
        ct, cj = _pair(code_name)
        _, cw = _words(cj, 2, seed=31)
        rx = _corrupt(cj, cw, [1, 2], seed=37)
        calls.clear()
        assert np.array_equal(ct.decode(ct.field.from_numpy(rx), errors=True)[1], [1, 2])
        assert calls and set(calls) == {kernel}
