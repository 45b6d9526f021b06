"""Large prime fields of the torch port against the JAX package.

GF(p) for p > 2^32 in planar 16-bit limb storage (the Goldilocks prime, the
BLS12-381 scalar field's 16 limbs, a 3-limb prime), GF(2^31 - 1), and the
kernels K9 (GF(2^31 - 1) multiply), K10 (Goldilocks multiply) and K11 (the
device probe): the same inputs, made with numpy from a seed, go through
``galois_tpu`` and ``galois_tpu_torch``. The tolerance is exact integer
equality. The kernels' plain versions are held against the JAX Pallas
kernels in interpret mode and against Python integers.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu.fields._meta import int_to_limbs as jax_int_to_limbs
from galois_tpu.ops._kernels import get_ops as jax_get_ops
from galois_tpu.ops._pallas import goldilocks_multiply_pallas, pallas_probe, prime_multiply_pallas
from galois_tpu_torch.fields._meta import int_to_limbs, limbs_to_int
from galois_tpu_torch.ops._elementwise import (
    device_probe,
    device_probe_plain,
    goldilocks_multiply,
    goldilocks_multiply_plain,
    m31_multiply,
    m31_multiply_plain,
)

GOLDILOCKS = 2**64 - 2**32 + 1
M31 = 2**31 - 1
BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
P40 = 1099511627791  # the smallest prime above 2^40: 3 limbs, int64 int reprs
FIELDS = [GOLDILOCKS, M31, BLS_R, P40]
EDGES = {
    GOLDILOCKS: [0, 1, GOLDILOCKS - 1, 2**32 - 1, 2**32, 2**63],
    M31: [0, 1, M31 - 1, 2**16, 2**30],
    BLS_R: [0, 1, BLS_R - 1, 2**64, 2**128 + 1],
    P40: [0, 1, P40 - 1, 2**32, 2**39],
}


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _uniform(p: int, n: int, seed: int, low: int = 0) -> np.ndarray:
    """n uniform ints in [low, p) as an object array, from 62-bit draws."""
    rng = np.random.default_rng(seed)
    words = -(-p.bit_length() // 62) + 1
    draws = rng.integers(0, 2**62, (n, words))
    vals = [sum(int(w) << (62 * i) for i, w in enumerate(row)) for row in draws]
    return np.array([low + v % (p - low) for v in vals], dtype=object)


def _operands(p: int, seed: int, n: int = 45):
    """Random elements (a ragged count) behind the field's edge values on
    both sides; b has no zeros."""
    edges = np.array(EDGES[p], dtype=object)
    a = np.concatenate([edges, edges[::-1], _uniform(p, n, seed)])
    b = np.concatenate([edges[::-1], edges, _uniform(p, n, seed + 1)])
    b[b == 0] = 1
    return a, b


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _host(p: int, fn, *arrays) -> np.ndarray:
    """The JAX package's exact host field, elementwise: the JAX device path
    would compile a long exponentiation chain for each inverse."""
    hf = get_host_field(gj.GF(p)._meta)
    out = [getattr(hf, fn)(*(int(v) for v in vals)) for vals in zip(*arrays)]
    return np.array(out, dtype=object)


# ----------------------------------------------------------------------
# Field construction and storage
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", FIELDS)
def test_limb_field_properties_match_jax(p):
    Ft, Fj = gt.GF(p), gj.GF(p)
    mt, mj = Ft._meta, Fj._meta
    assert (mt.storage, mt.storage_width, mt.storage_first) == (mj.storage, mj.storage_width, mj.storage_first)
    assert mt.internal_dtype == mj.internal_dtype
    assert Ft.dtypes == Fj.dtypes and Ft.default_dtype == Fj.default_dtype
    assert int(Ft.primitive_element) == int(Fj.primitive_element)
    assert mt.irreducible_poly_int == mj.irreducible_poly_int
    assert Ft.ufunc_modes == Fj.ufunc_modes
    if mj.storage == "limbs":
        assert mt.torch_dtype == torch.uint16
        assert np.array_equal(mt.prime_limbs, mj.prime_limbs)
        assert np.array_equal(mt.barrett_mu_limbs, mj.barrett_mu_limbs)
    for v in EDGES[p]:
        for count in (mt.storage_width or 2, 17):
            assert np.array_equal(int_to_limbs(v, count), jax_int_to_limbs(v, count))
            assert limbs_to_int(int_to_limbs(v, count)) == v


def test_bls12_381_factorization_is_fast():
    # the primitive root needs r - 1 factored; its factors reach 9 digits,
    # which Pollard's rho splits
    assert gt.pollard_rho(254760293 * 52437899) in (254760293, 52437899)
    primes, exps = gt.factors(BLS_R - 1)
    assert (primes, exps) == gj.factors(BLS_R - 1)
    assert max(primes) == 254760293
    assert gt.primitive_root(BLS_R) == gj.primitive_root(BLS_R) == 7


def test_other_limb_kinds_still_raise():
    # GF(2^m), m > 32, and odd p^m > 2^31, once raises, now the JAX package's fields
    for q, storage, width in ((2**40, "limbs", 3), (3**21, "digits", 21)):
        Ft, Fj = gt.GF(q), gj.GF(q)
        assert (Ft._meta.storage, Ft._meta.storage_width) == (Fj._meta.storage, Fj._meta.storage_width) == (storage, width)
        vals = [1, 2, q - 1, q // 3]
        _same(Ft(vals) * Ft(vals[::-1]), Fj(vals) * Fj(vals[::-1]))
    # the NTT over a limb field, once a raise, now the JAX package's transform
    _same(np.fft.fft(gt.GF(GOLDILOCKS)([1, 2, 3, 4])), np.fft.fft(gj.GF(GOLDILOCKS)([1, 2, 3, 4])))


@pytest.mark.parametrize("p", FIELDS)
def test_from_numpy_and_storage_round_trips(p):
    a, _ = _operands(p, seed=3)
    a = a[:48]
    Ft, Fj = gt.GF(p), gj.GF(p)
    xj = Fj(a.reshape(3, 16))
    xt = Ft.from_numpy(np.asarray(xj))
    _same(xt, xj)
    assert xt.shape == xj.shape and xt.ndim == 2 and xt.size == xj.size and len(xt) == 3
    # the JAX storage crosses over: planar (L, *shape) uint16 limbs as they
    # are (int storage widens from uint32)
    storage = torch.from_numpy(np.array(xj._data))
    if Ft._meta.storage_width:
        assert storage.dtype == xt._data.dtype == torch.uint16
    assert storage.shape == xt._data.shape
    assert torch.equal(storage.to(xt._data.dtype), xt._data)
    _same(Ft(storage), xj)
    _same(Ft(np.asarray(xt)), xj)
    _same(Ft(a.tolist()), Fj(a.tolist()))
    assert int(Ft(int(a[2]))) == int(a[2]) == Fj(int(a[2])).item()
    assert str(Ft(a[:3])) == str(Fj(a[:3])) and repr(Ft(a[:3])) == repr(Fj(a[:3]))
    with pytest.raises(ValueError):
        Ft.from_numpy(np.array([p], dtype=object))
    with pytest.raises(ValueError):
        Ft([0, -1])
    if Ft._meta.storage_width:
        with pytest.raises(ValueError):
            Ft(torch.zeros(Ft._meta.storage_width + 1, 3, dtype=torch.uint16))


# ----------------------------------------------------------------------
# Arithmetic through the public API
# ----------------------------------------------------------------------

@pytest.mark.parametrize("p", FIELDS)
def test_limb_arithmetic_matches_jax(p):
    a, b = _operands(p, seed=p % 997)
    Ft, Fj = gt.GF(p), gj.GF(p)
    xt, yt, xj, yj = Ft(a), Ft(b), Fj(a), Fj(b)
    _same(xt + yt, xj + yj)
    _same(xt - yt, xj - yj)
    _same(xt * yt, xj * yj)
    _same(-xt, -xj)
    _same(np.multiply(xt, yt), np.multiply(xj, yj))
    _same(np.subtract(xt, yt), np.subtract(xj, yj))
    _same(xt**3, xj**3)
    _same(xt**0, xj**0)
    _same(xt / yt, _host(p, "divide", a, b).astype(Fj.default_dtype))
    _same(np.reciprocal(yt), _host(p, "reciprocal", b).astype(Fj.default_dtype))
    _same(yt**-2, _host(p, "power", b, [-2] * len(b)).astype(Fj.default_dtype))
    e = np.array([0, 1, 2, p - 2, p - 1, p, 2**70 + 5, 3 * p + 7] * 4, dtype=object)
    base = yt[: len(e)]
    _same(base**e, _host(p, "power", b[: len(e)], e).astype(Fj.default_dtype))
    zeros = Ft([0, 0, 0])
    e = np.array([0, 1, p - 1], dtype=object)
    _same(zeros**e, Fj([0, 0, 0]) ** e)


@pytest.mark.parametrize("p", FIELDS)
def test_limb_indexing_reshape_broadcasting_match_jax(p):
    a, b = _operands(p, seed=5, n=6)
    a, b = a[:16], b[:16]
    Ft, Fj = gt.GF(p), gj.GF(p)
    xt, xj = Ft(a.reshape(4, 4)), Fj(a.reshape(4, 4))
    _same(xt[1], xj[1])
    _same(xt[1:3, ::2], xj[1:3, ::2])
    _same(xt[..., 2], xj[..., 2])
    _same(xt[2, 3], xj[2, 3])
    _same(xt.reshape(2, 8), xj.reshape(2, 8))
    _same(xt.reshape(16)[5:], xj.reshape(16)[5:])
    col, row = b[:4].reshape(4, 1), b[4:7].reshape(1, 3)
    _same(Ft(col) * Ft(row), Fj(col) * Fj(row))
    _same(Ft(col) + Ft(row), Fj(col) + Fj(row))
    _same(Ft(row) - Ft(col), Fj(row) - Fj(col))
    _same(xt * Ft(int(b[0])), xj * Fj(int(b[0])))  # a 0-d operand
    _same(Ft(int(b[1])) - xt, Fj(int(b[1])) - xj)
    _same(xt * 3, xj * 3)  # an integer operand to multiply is repeated addition
    _same(5 * xt[0], 5 * xj[0])
    _same(xt[0] + Ft(b[4:8]), xj[0] + Fj(b[4:8]))
    assert np.array_equal(xt == xt, xj == xj)
    assert np.array_equal(xt == Ft(int(a[5])), xj == Fj(int(a[5])))
    assert np.array_equal(xt[0] != Ft(b[:4]), xj[0] != Fj(b[:4]))
    assert np.array_equal(xt == Ft(b[:4]), xj == Fj(b[:4]))  # a row against a matrix


@pytest.mark.parametrize("p", FIELDS)
def test_random_stays_in_range(p):
    F = gt.GF(p)
    for low, high in ((0, None), (p - 5, None), (1, 3), (2**20, 2**33 + 7)):
        if high is not None and high > p:
            continue
        x = F.Random((3, 50), low=low, high=high, seed=p % 13)
        vals = np.asarray(x, dtype=object).reshape(-1)
        hi = p if high is None else high
        assert x.shape == (3, 50)
        assert all(low <= int(v) < hi for v in vals)
    g = torch.Generator().manual_seed(1)
    x = F.Random(400, generator=g)
    assert len(set(np.asarray(x, dtype=object).tolist())) > 390  # wide draws, not a few values
    assert np.array_equal(np.asarray(F.Random(8, seed=2)), np.asarray(F.Random(8, seed=2)))
    z = F.Zeros((2, 3))
    assert z.shape == (2, 3) and not np.asarray(z, dtype=object).any()


@pytest.mark.parametrize("p", FIELDS)
def test_division_by_zero_raises_like_jax(p):
    for pkg in (gt, gj):
        F = pkg.GF(p)
        with pytest.raises(ZeroDivisionError):
            F([1, 2]) / F([1, 0])
        with pytest.raises(ZeroDivisionError):
            F([0, 2]) ** -1
        with pytest.raises(ZeroDivisionError):
            np.reciprocal(F([3, 0]))
        with pytest.raises(TypeError):
            F([1, 2]) + 1


def test_limb_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    F = gt.GF(GOLDILOCKS)
    f = gt.Poly([1, 2, 3], field=F)
    with gt.default_device("cuda"):
        for make in (
            lambda: F([1, 2]),
            lambda: F.from_numpy(np.array([1, 2], dtype=object)),
            lambda: F.Zeros(3),
            lambda: F.Random(3, seed=1),
            lambda: f([1, 2]),
        ):
            with pytest.raises(RuntimeError, match="set_default_device"):
                make()
    assert f(F([1, 2])).device == torch.device("cpu")


# ----------------------------------------------------------------------
# Kernel K9: GF(2^31 - 1) multiply
# ----------------------------------------------------------------------

def test_m31_multiply_plain_matches_pallas_and_jax_ops():
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    n = 9_003  # not a multiple of the TPU kernel's (8, 1024) block
    a = rng.integers(0, M31, n)
    b = rng.integers(0, M31, n)
    a[:6] = [0, 1, M31 - 1, M31 - 1, 0, 2**16]
    b[:6] = [M31 - 1, M31 - 1, M31 - 1, 1, 0, 2**15]
    want = np.asarray(prime_multiply_pallas(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)), M31, True))
    meta = gj.GF(M31)._meta
    ops_j = np.asarray(jax_get_ops(meta, "jit-calculate").multiply(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)))
    got = m31_multiply_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.numpy(), ops_j.astype(np.int64))
    assert np.array_equal(got.numpy()[:200], (a[:200].astype(object) * b[:200] % M31).astype(np.int64))


def test_m31_multiply_wrapper_routes_and_counts():
    F = gt.GF(M31)
    x, y = F([3, M31 - 1, 0]), F([5, M31 - 1, 7])
    before = m31_multiply.launches
    assert np.array_equal(np.asarray(x * y), [15, 1, 0])  # PrimeOps.multiply takes K9's wrapper
    assert m31_multiply.launches == before  # the plain version is no launch
    col = torch.tensor([[1], [2]])
    assert torch.equal(m31_multiply(col, torch.tensor([3, 4, 5])), m31_multiply_plain(col, torch.tensor([3, 4, 5])))
    with pytest.raises(ValueError):
        m31_multiply(col.to("meta"), col.to("meta"))


# ----------------------------------------------------------------------
# Kernel K10: Goldilocks multiply
# ----------------------------------------------------------------------

def _gold_planes(values) -> np.ndarray:
    v = np.array(values, dtype=object).astype(np.uint64)
    return np.stack([((v >> np.uint64(16 * k)) & np.uint64(0xFFFF)).astype(np.uint16) for k in range(4)])


def test_goldilocks_multiply_plain_matches_pallas_and_jax_ops():
    import jax.numpy as jnp

    rng = np.random.default_rng(64)
    n = 9_001
    # random limbs give values anywhere in [0, 2^64); the edge values add
    # the non-canonical p, p + 5 and 2^64 - 1 on purpose
    A = rng.integers(0, 2**16, (4, n)).astype(np.uint16)
    B = rng.integers(0, 2**16, (4, n)).astype(np.uint16)
    edges = [0, 1, GOLDILOCKS - 1, 2**32 - 1, 2**32, 2**64 - 1, GOLDILOCKS, GOLDILOCKS + 5]
    A[:, : len(edges)] = _gold_planes(edges)
    B[:, : len(edges)] = _gold_planes(edges[::-1])
    B[:, len(edges) : 2 * len(edges)] = _gold_planes(edges)
    want = np.asarray(goldilocks_multiply_pallas(jnp.asarray(A), jnp.asarray(B), True))
    ops_j = np.asarray(jax_get_ops(gj.GF(GOLDILOCKS)._meta, "jit-calculate").multiply(jnp.asarray(A), jnp.asarray(B)))
    got = goldilocks_multiply_plain(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.uint16 and got.shape == (4, n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), ops_j)
    ints = lambda P: sum(P[k].astype(object) << (16 * k) for k in range(4))  # noqa: E731
    assert list(ints(got.numpy()[:, :300])) == list(ints(A[:, :300]) * ints(B[:, :300]) % GOLDILOCKS)
    assert (ints(got.numpy()) < GOLDILOCKS).all()  # canonical


def test_goldilocks_multiply_broadcasts_behind_the_limb_axis():
    rng = np.random.default_rng(7)
    acc = torch.from_numpy(rng.integers(0, 2**16, (4, 3, 50)).astype(np.uint16))
    x = torch.from_numpy(rng.integers(0, 2**16, (4, 50)).astype(np.uint16))
    got = goldilocks_multiply(acc, x)  # Horner's (k, N) times (N,)
    assert got.shape == (4, 3, 50)
    for i in range(3):
        assert torch.equal(got[:, i], goldilocks_multiply_plain(acc[:, i], x))
    before = goldilocks_multiply.launches
    assert torch.equal(goldilocks_multiply(x, acc), got)
    assert goldilocks_multiply.launches == before
    with pytest.raises(ValueError):
        goldilocks_multiply(x.to("meta"), x.to("meta"))


# ----------------------------------------------------------------------
# Kernel K11: the device probe
# ----------------------------------------------------------------------

def test_device_probe_plain_matches_pallas_probe():
    want = np.asarray(pallas_probe(True))
    x = torch.zeros((8, 1024), dtype=torch.int32)
    got = device_probe_plain(x)
    assert got.shape == want.shape == (8, 1024)
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    before = device_probe.launches
    assert torch.equal(device_probe(x), got)
    assert device_probe.launches == before
    with pytest.raises(ValueError):
        device_probe(x.to("meta"))
