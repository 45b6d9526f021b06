"""Lookup mode and small odd extension fields of the torch port against the
JAX package.

The same inputs, made with numpy from a seed, go through ``galois_tpu`` and
``galois_tpu_torch``; the tolerance is exact integer equality. Kernels
K3-K6 (the EXP/LOG table gathers) are held here through their plain
versions against the JAX Pallas kernels in interpret mode; the kernels
themselves run only on a CUDA card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields import _factory as jax_factory
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu.fields._tables import build_exp_log as jax_build_exp_log
from galois_tpu.ops._kernels import get_ops as jax_get_ops
from galois_tpu.ops._pallas._elementwise import (
    _pad128,
    lookup_divide_pallas,
    lookup_log_pallas,
    lookup_multiply_pallas,
    lookup_reciprocal_pallas,
)
from galois_tpu_torch.fields import _factory as torch_factory
from galois_tpu_torch.fields._tables import build_exp_log
from galois_tpu_torch.ops import _kernels
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops._lookup import (
    lookup_divide,
    lookup_divide_plain,
    lookup_log,
    lookup_log_plain,
    lookup_multiply,
    lookup_multiply_plain,
    lookup_reciprocal,
    lookup_reciprocal_plain,
)

ARITH_ORDERS = [2**8, 3**5, 5**3, 7**4, 3**10]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


@pytest.fixture(autouse=True)
def _restore_modes():
    """GF(q, compile=...) switches a class that each package caches: put
    every class back in the mode it had, so that no lookup-mode field leaks
    into later tests of the same worker."""
    caches = (jax_factory._FIELD_CACHE, torch_factory._FIELD_CACHE)
    saved = [{k: cls._mode for k, cls in c.items()} for c in caches]
    yield
    for cache, modes in zip(caches, saved):
        for k, cls in cache.items():
            cls._mode = modes.get(k, cls._meta.default_ufunc_mode)


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _operands(q, seed, n=200):
    """Seeded elements with zeros, ones and q - 1 at the front."""
    rng = np.random.default_rng(seed)
    head = np.array([0, 1, q - 1, 0, 2, q - 2, 1, 0], dtype=np.int64)
    a = np.concatenate([head, rng.integers(0, q, n, dtype=np.int64)])
    b = np.concatenate([head[::-1], rng.integers(0, q, n, dtype=np.int64)])
    return a, b


def _nonzero(x):
    x = x.copy()
    x[x == 0] = 1
    return x


# ----------------------------------------------------------------------
# Kernels K3-K6: plain versions against the Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q", [2**8, 3**5, 5**3, 2**10])
def test_lookup_plain_matches_pallas_interpret(q):
    Fj, Ft = gj.GF(q), gt.GF(q)
    jops, tops = jax_get_ops(Fj._meta, "jit-lookup"), get_ops(Ft._meta, "jit-lookup")
    assert np.array_equal(tops.EXP, jops.EXP) and np.array_equal(tops.LOG, jops.LOG)
    exp_p, log_p = jnp.asarray(_pad128(jops.EXP)), jnp.asarray(_pad128(jops.LOG))
    exp_t, log_t = torch.from_numpy(tops.EXP), torch.from_numpy(tops.LOG)
    rng = np.random.default_rng(q)
    a = rng.integers(0, q, 2000)
    b = rng.integers(0, q, 2000)
    a[:7], b[3:10] = 0, 0  # zeros on each side and on both
    dt_j, dt_t = Fj._meta.internal_dtype, Ft._meta.torch_dtype
    aj, bj = jnp.asarray(a.astype(dt_j)), jnp.asarray(b.astype(dt_j))
    at, bt = torch.from_numpy(a).to(dt_t), torch.from_numpy(b).to(dt_t)

    def same(got, want):
        assert np.array_equal(got.to(torch.int64).numpy(), np.asarray(want).astype(np.int64))

    same(lookup_multiply_plain(at, bt, exp_t, log_t, q), lookup_multiply_pallas(aj, bj, exp_p, log_p, q, True))
    same(lookup_divide_plain(at, bt, exp_t, log_t, q), lookup_divide_pallas(aj, bj, exp_p, log_p, q, True))
    same(lookup_reciprocal_plain(at, exp_t, log_t, q), lookup_reciprocal_pallas(aj, exp_p, log_p, q, True))
    same(lookup_log_plain(at, log_t, q), lookup_log_pallas(aj, log_p, q, True))
    assert lookup_multiply_plain(at, bt, exp_t, log_t, q).dtype == dt_t
    assert lookup_log_plain(at, log_t, q).dtype == torch.int64


def test_lookup_wrappers_use_plain_on_cpu_only():
    ops = get_ops(gt.GF(2**8)._meta, "jit-lookup")
    exp_t, log_t = (torch.from_numpy(t) for t in (ops.EXP, ops.LOG))
    a = torch.arange(256, dtype=torch.uint8)
    b = a.flip(0)
    before = [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)]
    assert torch.equal(lookup_multiply(a, b, exp_t, log_t, 256), lookup_multiply_plain(a, b, exp_t, log_t, 256))
    assert torch.equal(lookup_divide(a, b, exp_t, log_t, 256), lookup_divide_plain(a, b, exp_t, log_t, 256))
    assert torch.equal(lookup_reciprocal(a, exp_t, log_t, 256), lookup_reciprocal_plain(a, exp_t, log_t, 256))
    assert torch.equal(lookup_log(a, log_t, 256), lookup_log_plain(a, log_t, 256))
    # the plain version is no launch
    assert [f.launches for f in (lookup_multiply, lookup_divide, lookup_reciprocal, lookup_log)] == before
    # not CPU and not CUDA: raise rather than fall back
    meta = a.to("meta")
    with pytest.raises(ValueError):
        lookup_multiply(meta, meta, exp_t, log_t, 256)
    with pytest.raises(ValueError):
        lookup_log(meta, log_t, 256)


# ----------------------------------------------------------------------
# Tables and dispatch
# ----------------------------------------------------------------------

@pytest.mark.parametrize("q", [2**8, 3**5, 5**3, 7**4, 2**10, 2**16])
def test_build_exp_log_matches_jax(q):
    exp, log = build_exp_log(gt.GF(q)._meta)
    exp_j, log_j = jax_build_exp_log(gj.GF(q)._meta)
    assert exp.dtype == exp_j.dtype and np.array_equal(exp, exp_j)
    assert log.dtype == log_j.dtype and np.array_equal(log, log_j)
    assert exp.shape == (2 * (q - 1),) and log.shape == (q,)


@pytest.mark.parametrize(
    ["q", "mode", "op", "kernel"],
    [
        (2**8, "jit-lookup", lambda x, y: x * y, "lookup_multiply"),
        (2**8, "jit-lookup", lambda x, y: x / y, "lookup_divide"),
        (2**8, "jit-lookup", lambda x, y: np.reciprocal(y), "lookup_reciprocal"),
        (2**8, "jit-lookup", lambda x, y: y**-1, "lookup_reciprocal"),
        (2**16, "jit-lookup", lambda x, y: x * y, "lookup_multiply"),
        (3**5, "jit-lookup", lambda x, y: x / y, "lookup_divide"),
        (3**5, "jit-calculate", lambda x, y: x * y, "lookup_multiply"),
        (3**8, "jit-calculate", lambda x, y: x * y, None),  # order > 4096: digit multiply
        (2**8, "jit-calculate", lambda x, y: x * y, None),  # K7, not a table kernel
    ],
)
def test_public_ops_route_to_the_table_kernels(monkeypatch, q, mode, op, kernel):
    """Dispatch depends on the field and mode only, so the CPU runs the
    routing the card runs: count the wrapper calls."""
    calls = []
    for name in ("lookup_multiply", "lookup_divide", "lookup_reciprocal"):
        real = getattr(_kernels, name)
        monkeypatch.setattr(_kernels, name, lambda *args, _n=name, _f=real: calls.append(_n) or _f(*args))
    F = gt.GF(q, compile=mode)
    x, y = F(np.arange(1, 41) % q), F(np.arange(1, 41) % (q - 1) + 1)
    op(x, y)
    assert calls == ([kernel] if kernel else [])


def test_lookup_mode_contract():
    for q in (2**8, 3**5, 2**20):
        assert gt.GF(q).ufunc_modes == gj.GF(q).ufunc_modes
        assert gt.GF(q).default_ufunc_mode == gj.GF(q).default_ufunc_mode == "jit-calculate"
    assert gt.GF(2).ufunc_modes == gj.GF(2).ufunc_modes
    F = gt.GF(2**8)
    F.compile("jit-lookup")
    assert F.ufunc_mode == "jit-lookup"
    F.compile("auto")
    assert F.ufunc_mode == "jit-calculate"
    with pytest.raises(ValueError):
        gt.GF(2).compile("jit-lookup")
    with pytest.raises(ValueError):
        gt.GF(2**21, compile="jit-lookup")
    with pytest.raises(NotImplementedError):
        F.compile("python-calculate")
    with pytest.raises(NotImplementedError):
        gt.GF(3**5)([1, 2]).log()  # log() in 'jit-calculate' mode is not ported


# ----------------------------------------------------------------------
# Arithmetic parity in both modes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["jit-calculate", "jit-lookup"])
@pytest.mark.parametrize("q", ARITH_ORDERS)
def test_arithmetic_matches_jax(q, mode):
    Ft, Fj = gt.GF(q, compile=mode), gj.GF(q, compile=mode)
    a, b = _operands(q, seed=q)
    bn = _nonzero(b)
    xt, yt, ynt = Ft(a), Ft(b), Ft(bn)
    xj, yj, ynj = Fj(a), Fj(b), Fj(bn)
    _same(xt + yt, xj + yj)
    _same(xt - yt, xj - yj)
    _same(xt * yt, xj * yj)
    _same(-xt, -xj)
    _same(xt / ynt, xj / ynj)
    _same(np.reciprocal(ynt), np.reciprocal(ynj))
    _same(xt * 5, xj * 5)
    for e in (0, 1, 3):
        _same(xt**e, xj**e)
    # large static exponents against the JAX package's exact host field
    # (its device path compiles a ladder per exponent, seconds each)
    hf = get_host_field(Fj._meta)
    for e in (q - 1, q, 2**70 + 3):
        want = np.array([hf.power(int(v), e) for v in a]).astype(Fj._meta.internal_dtype)
        _same(xt**e, want)
    for e in (-1, -5):
        _same(ynt**e, ynj**e)
    exps = np.random.default_rng(3).integers(-40, 40, a.shape[0])
    exps[:4] = [0, 7, 0, -3]
    _same(ynt**exps, ynj**exps)
    zero_base = np.zeros(4, dtype=np.int64)
    e4 = np.array([0, 1, 2, q - 1])
    _same(Ft(zero_base) ** e4, Fj(zero_base) ** e4)


@pytest.mark.parametrize("q", ARITH_ORDERS)
def test_log_matches_jax(q):
    Ft, Fj = gt.GF(q, compile="jit-lookup"), gj.GF(q, compile="jit-lookup")
    a = _nonzero(_operands(q, seed=q + 1)[0])
    _same(Ft(a).log(), Fj(a).log())
    # a base alpha^k generates the units iff gcd(k, q - 1) = 1
    k_gen = next(k for k in range(2, q) if np.gcd(k, q - 1) == 1)
    k_not = next(k for k in range(2, q) if (q - 1) % k == 0)
    base = int(Fj.primitive_element**k_gen)
    _same(Ft(a).log(base), Fj(a).log(base))
    _same(Ft(a).log(Ft(base)), Fj(a).log(base))
    bad = int(Fj.primitive_element**k_not)
    for F in (Ft, Fj):
        with pytest.raises(ArithmeticError):
            F(a).log(bad)
        with pytest.raises(ArithmeticError):
            F([1, 0]).log()
    got = Ft(a[5]).log()
    assert isinstance(got, np.int64) and got == Fj(a[5]).log()


# ----------------------------------------------------------------------
# State carried across, and the slice as a whole
# ----------------------------------------------------------------------

def test_load_tables_from_jax_gives_the_same_results():
    q = 3**5
    Ft, Fj = gt.GF(q), gj.GF(q)
    jops = jax_get_ops(Fj._meta, "jit-lookup")
    own = _kernels.LookupOps(get_ops(Ft._meta, "jit-calculate"))
    loaded = _kernels.LookupOps(get_ops(Ft._meta, "jit-calculate"))
    loaded.load_tables(jops.EXP, jops.LOG)
    a, b = (torch.from_numpy(v).to(Ft._meta.torch_dtype) for v in _operands(q, seed=9))
    bn = torch.where(b == 0, torch.ones_like(b), b)
    for fn in ("multiply", "divide"):
        assert torch.equal(getattr(loaded, fn)(a, bn), getattr(own, fn)(a, bn))
    assert torch.equal(loaded.reciprocal(bn), own.reciprocal(bn))
    assert torch.equal(loaded.log_alpha(bn), own.log_alpha(bn))
    with pytest.raises(ValueError):
        loaded.load_tables(jops.EXP[:-1], jops.LOG)


@pytest.mark.parametrize(["q", "mode"], [(2**8, "jit-lookup"), (3**5, "jit-calculate"), (3**5, "jit-lookup")])
def test_composite_matches_jax(q, mode):
    Ft, Fj = gt.GF(q, compile=mode), gj.GF(q, compile=mode)
    rng = np.random.default_rng(q)
    x, y, z, w = (rng.integers(1, q, (6, 7)) for _ in range(4))
    got = (Ft(x) * Ft(y) + Ft(z)) / Ft(w) ** 3
    want = (Fj(x) * Fj(y) + Fj(z)) / Fj(w) ** 3
    _same(got, want)
    nz = _nonzero(np.asarray(want).astype(np.int64))
    Ft.compile("jit-lookup")
    Fj.compile("jit-lookup")
    _same(Ft(nz).log(), Fj(nz).log())
