"""Discrete logarithms of the torch port against the JAX package.

``log`` and ``np.log`` in the default mode and in lookup mode, with and
without ``base=``, over the fields of the port's CPU probe, GF(2),
GF(2^32 - 5) and the Goldilocks field (the host route), GF(3 * 2^30 + 1)
(the device Pohlig-Hellman with 30 binary digits) and GF(2^24) (the device
Pohlig-Hellman over GF(2^m)). The same inputs, made with numpy from a seed,
go through ``galois_tpu`` and ``galois_tpu_torch`` on the CPU; the
tolerance is exact integer equality of the returned arrays and their
dtypes, and the exception types must agree.

A discrete log is unique, so each route must give the same integers as
any of the JAX package's. Where its jitted Pohlig-Hellman takes long to
compile on the CPU (GF(2^16) 26 s, GF(65537) 270 s, GF(3 * 2^30 + 1) over
ten minutes, GF(2^31 - 1) 23 s for each base), the port's default mode is
held to the JAX package's lookup-mode log (orders <= 2^20) or to its
``host_log`` (its exact Python-int Pohlig-Hellman) instead; GF(2^31 - 1)
meets the JAX device route once, without a base.

Known deviation: a base that does not generate the multiplicative group
raises ArithmeticError in the port on every route; the JAX package raises
so in lookup mode only, and its default-mode device route returns one of
the exponents x with base^x = element.
"""

import math

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu.ops import _dlog as jax_dlog
from galois_tpu_torch.fields import _factory as torch_factory
from galois_tpu_torch.ops import _dlog

M31 = 2**31 - 1
NTT_P = 3 * 2**30 + 1
GOLDILOCKS = 2**64 - 2**32 + 1

# (id, order): the CPU probe's ten fields, GF(2), and the Goldilocks field
ORDERS = [
    ("GF16", 2**4), ("GF256", 2**8), ("GF8192", 2**13), ("GF65536", 2**16), ("GF243", 3**5),
    ("GF125", 5**3), ("GF7", 7), ("GF65537", 65537), ("M31", M31), ("P32", 2**32 - 5),
    ("GF2", 2), ("Goldilocks", GOLDILOCKS),
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


def units(q, shape, rng):
    """Uniform nonzero int reprs: int64, or object ints above 2^62."""
    if q <= 2**62:
        return rng.integers(1, q, shape, dtype=np.int64)
    hi, lo = (rng.integers(0, 2**32, shape).astype(object) for _ in range(2))
    return (hi * 2**32 + lo) % (q - 1) + 1


def same(a, b):
    assert type(a) is type(b)
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tolist() == b.tolist()


def outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001  (the type is compared)
        return type(e)


def generator(q, k):
    """alpha^k for the smallest k' >= k coprime to q - 1 (a generator)."""
    k = next(j for j in range(k, k + q) if math.gcd(j, q - 1) == 1)
    F = gt.GF(q)
    return int(F.primitive_element ** k)


# default-mode fields whose JAX Pohlig-Hellman compiles slowly on the CPU
SLOW_JAX = {2**16, 65537, M31}


def jax_log(G, x, base=None):
    """The JAX package's logs of the int reprs x: its public ``log`` in G's
    mode, or for SLOW_JAX in the default mode its lookup-mode ``log``
    (orders <= 2^20) or ``host_log`` (GF(2^31 - 1), but for the 2-D array
    without a base)."""
    if G._mode == "jit-lookup" or G.order not in SLOW_JAX or (G.order == M31 and base is None and np.ndim(x) == 2):
        return G(x).log(base)
    if G.order == M31:
        out = np.array([jax_dlog.host_log(G._meta, int(v), base) for v in np.ravel(x)]).reshape(np.shape(x))
        return out if out.ndim else np.int64(out)
    G.compile("jit-lookup")
    try:
        return G(x).log(base)
    finally:
        G.compile("auto")


@pytest.mark.parametrize(["fid", "q", "mode"], CASES, ids=CASE_IDS)
def test_log_matches_jax(fid, q, mode):
    """x.log() and np.log(x) of random units (1 and q - 1 among them), 2-D
    and 0-D, and with a generating base other than the primitive element."""
    F, G = fields(q, mode)
    x = units(q, (4, N // 4), np.random.default_rng(q % 1000 + 11))
    x[0, 0], x[0, 1] = 1, q - 1
    got = F(x).log()
    same(got, jax_log(G, x))
    same(np.log(F(x)), got)
    same(F(int(x[1, 1])).log(), jax_log(G, int(x[1, 1])))
    if q > 2:
        b = generator(q, 5)
        same(F(x[1]).log(b), jax_log(G, x[1], b))
        inv = pow(jax_dlog.host_log(G._meta, b), -1, q - 1)
        assert F(x[1]).log(F(b)).tolist() == [int(v) * inv % (q - 1) for v in got[1]]


@pytest.mark.parametrize(["fid", "q", "mode"], CASES, ids=CASE_IDS)
def test_log_of_zero_raises(fid, q, mode):
    F, G = fields(q, mode)
    assert outcome(lambda: F([1, 0]).log()) is outcome(lambda: G([1, 0]).log()) is ArithmeticError
    assert outcome(lambda: F(1).log(0)) is ArithmeticError


@pytest.mark.parametrize(["fid", "q"], [o for o in ORDERS if o[0] in LOOKUP], ids=[o[0] for o in ORDERS if o[0] in LOOKUP])
def test_non_generating_base_raises(fid, q):
    """In lookup mode both packages raise ArithmeticError; in the default
    mode the port raises too (the known deviation above)."""
    F, G = fields(q, "jit-lookup")
    b = int(F.primitive_element ** next(k for k in range(2, q) if math.gcd(k, q - 1) > 1))
    assert outcome(lambda: F([1, 2]).log(b)) is outcome(lambda: G([1, 2]).log(b)) is ArithmeticError
    F.compile("auto")
    assert outcome(lambda: F([1, 2]).log(b)) is ArithmeticError


def test_log_on_the_device_pohlig_hellman_against_jax_host_log():
    """GF(3 * 2^30 + 1) (digits of the 2^30 subgroup), GF(2^31 - 1) (seven
    prime factors, the largest 331) and GF(2^24) (GF(2^m) storage above the
    lookup cutoff): the port's device route against the JAX package's
    host_log of every element; each takes the device route."""
    for q in (NTT_P, M31, 2**24):
        F, G = fields(q)
        assert _dlog._device_capable(F._meta) and q > 2**20
        x = units(q, 48, np.random.default_rng(q % 1000 + 12))
        x[:3] = [1, q - 1, int(F.primitive_element)]
        want = [jax_dlog.host_log(G._meta, int(v)) for v in x]
        assert F(x).log().tolist() == want
        assert _dlog.host_log(F._meta, int(x[5])) == want[5]
        b = generator(q, 7)
        lb = jax_dlog.host_log(G._meta, b)
        assert F(x).log(b).tolist() == [w * pow(lb, -1, q - 1) % (q - 1) for w in want]


def test_routes(monkeypatch):
    """Orders <= 2^20 read the LOG table (K6's wrapper) in both modes;
    larger int storage with a smooth q - 1 runs the device Pohlig-Hellman;
    limb storage and q - 1 with a prime factor above 2^20 the host's."""
    from galois_tpu_torch.ops import _kernels

    calls = []
    for name, mod in (("lookup_log", _kernels), ("_device_log", _dlog), ("host_log", _dlog)):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    want = {2**16: "lookup_log", 3**5: "lookup_log", 65537: "lookup_log", M31: "_device_log",
            2**32 - 5: "host_log", GOLDILOCKS: "host_log"}
    for q, route in want.items():
        calls.clear()
        gt.GF(q)([1, 2]).log()
        assert calls and set(calls) == {route}, (q, calls)
