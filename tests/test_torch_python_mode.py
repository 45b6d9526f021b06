"""The 'python-calculate' ufunc mode of the torch port against the JAX
package in the same mode.

In that mode the elementwise arithmetic (``+``, ``-``, ``*``, ``/``,
negation, reciprocals, powers, ``np.sqrt``) runs on exact host ints and
the result goes back to the operands' device; Poly products, division and
evaluation, the matrix char and min polys and ``berlekamp_massey`` take
their host loops; every other route (``np.convolve``, the NTT, ``log``,
``inv``/``det``, LFSR steps, RS and BCH decoding, reductions) runs the
default mode's device ops, as the JAX package routes them. Each result must
equal the JAX package's in the same mode, on the same seeded NumPy inputs.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.fields import _array
from galois_tpu_torch.ops import _kernels

from tests.test_torch_setitem import FIELDS, _ints, _name


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _python_mode(*fields):
    """Switch the classes to python-calculate; the fixture's teardown puts
    'auto' back, so that no other test of the process finds the mode."""
    for F in fields:
        F.compile("python-calculate")


@pytest.fixture
def restore():
    touched = []
    yield touched
    for F in touched:
        F.compile("auto")


@pytest.fixture(params=FIELDS, ids=_name, scope="module")
def fields(request):
    q = request.param
    args = q if isinstance(q, tuple) else (q,)
    return gt.GF(*args), gj.GF(*args)


ELEMENTWISE = {
    "add": lambda x, y, e: x + y,
    "subtract": lambda x, y, e: x - y,
    "multiply": lambda x, y, e: x * y,
    "multiply_int": lambda x, y, e: x * 3,
    "divide": lambda x, y, e: x / y,
    "negative": lambda x, y, e: -x,
    "reciprocal": lambda x, y, e: np.reciprocal(y),
    "square": lambda x, y, e: np.square(x),
    "power": lambda x, y, e: x**5,
    "power_negative": lambda x, y, e: y**-3,
    "power_zero": lambda x, y, e: x**0,
    "power_array": lambda x, y, e: y**e,
    "sqrt": lambda x, y, e: np.sqrt(x * x),
    "broadcast": lambda x, y, e: x[:, None] * y[None, :3],
}


@pytest.mark.parametrize("op", list(ELEMENTWISE))
def test_elementwise_matches_jax_and_the_device_modes(fields, restore, op):
    Ft, Fj = fields
    x, y = _ints(Ft.order, (8,), seed=1), _ints(Ft.order, (8,), seed=2, low=1)
    e = np.random.default_rng(3).integers(-(2**40), 2**40, size=8, dtype=np.int64)
    on_device = np.asarray(ELEMENTWISE[op](Ft(x), Ft(y), e))
    restore.extend([Ft, Fj])
    _python_mode(Ft, Fj)
    got = ELEMENTWISE[op](Ft(x), Ft(y), e)
    want = ELEMENTWISE[op](Fj(x), Fj(y), e)
    assert type(got) is Ft and got.device == Ft(x).device
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(np.asarray(got), on_device)


def test_elementwise_ops_run_on_host_ints(monkeypatch, restore):
    """In python-calculate the operators call the host op and no device op."""
    F = gt.GF(2**8)
    restore.append(F)
    _python_mode(F)
    ops = _kernels.get_ops(F._meta, "jit-calculate")
    device_calls, host_calls = [], []
    for name in ("multiply", "multiply_bulk", "add", "divide", "reciprocal", "power_static", "power", "sqrt"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: device_calls.append(_n))
    real = _array._python_op
    monkeypatch.setattr(_array, "_python_op", lambda *a: host_calls.append(a[1]) or real(*a))
    x, y = F([1, 2, 3]), F([4, 5, 6])
    x * y, x + y, x / y, np.reciprocal(y), x**3, x ** np.array([1, 2, 3]), np.sqrt(x)
    assert device_calls == []
    assert host_calls == ["multiply", "add", "divide", "reciprocal", "power", "power", "sqrt"]
    assert _kernels.get_ops(F._meta, "python-calculate") is ops  # the composite routes' ops
    assert _kernels.kernel_mode(F) == "jit-calculate"


def test_mode_is_checked_and_restored():
    F = gt.GF(2**8)
    try:
        gt.GF(2**8, compile="python-calculate")
        assert F.ufunc_mode == "python-calculate"
    finally:
        F.compile("auto")
    assert F.ufunc_mode == "jit-calculate"
    with pytest.raises(ValueError):
        F.compile("python")


def _poly_pair(order, degree, seed):
    c = _ints(order, (degree + 1,), seed=seed)
    c[0] = 1
    return gt.Poly(c.tolist(), field=gt.GF(order)), gj.Poly(c.tolist(), field=gj.GF(order))


def _same_poly(a, b):
    assert a.degree == b.degree
    assert np.array_equal(np.asarray(a.coefficients()), np.asarray(b.coefficients()))


@pytest.mark.parametrize("order", [2**8, 7, 2**64 - 2**32 + 1])
def test_poly_routes_match_jax(restore, order):
    """Product, divmod and evaluation in python-calculate (their host loops
    in both packages)."""
    Ft, Fj = gt.GF(order), gj.GF(order)
    restore.extend([Ft, Fj])
    _python_mode(Ft, Fj)
    at, aj = _poly_pair(order, 40, 1)
    bt, bj = _poly_pair(order, 13, 2)
    _same_poly(at * bt, aj * bj)
    (qt, rt), (qj, rj) = divmod(at, bt), divmod(aj, bj)
    _same_poly(qt, qj)
    _same_poly(rt, rj)
    pts = _ints(order, (16,), seed=3)
    got, want = at(Ft(pts)), aj(Fj(pts))
    assert type(got) is Ft and np.array_equal(np.asarray(got), np.asarray(want))
    assert int(at(Ft(int(pts[0])))) == int(aj(Fj(int(pts[0]))))


def test_device_routes_match_jax(restore):
    """np.convolve, the NTT, log, inv and det, in python-calculate: the
    default mode's device ops in both packages."""
    F8t, F8j, Fpt, Fpj = gt.GF(2**8), gj.GF(2**8), gt.GF(257), gj.GF(257)
    restore.extend([F8t, F8j, Fpt, Fpj])
    _python_mode(F8t, F8j, Fpt, Fpj)
    a, b = _ints(256, (40,), seed=4), _ints(256, (30,), seed=5)
    assert np.array_equal(np.asarray(np.convolve(F8t(a), F8t(b))), np.asarray(np.convolve(F8j(a), F8j(b))))
    v = _ints(257, (16,), seed=6)
    assert np.array_equal(np.asarray(np.fft.fft(Fpt(v))), np.asarray(np.fft.fft(Fpj(v))))
    assert np.array_equal(np.asarray(gt.ntt(v.tolist(), modulus=257)), np.asarray(gj.ntt(v.tolist(), modulus=257)))
    nz = _ints(256, (12,), seed=7, low=1)
    assert np.array_equal(F8t(nz).log(), np.asarray(F8j(nz).log()))
    A = _ints(257, (5, 5), seed=8)
    assert np.array_equal(np.asarray(np.linalg.inv(Fpt(A))), np.asarray(np.linalg.inv(Fpj(A))))
    assert int(np.linalg.det(Fpt(A))) == int(np.linalg.det(Fpj(A)))


def test_lfsr_and_berlekamp_massey_match_jax(restore):
    """An LFSR step (the default mode's scan) and berlekamp_massey of 600
    elements (above the device scan's 512, so the host loop in this mode)."""
    F7t, F7j = gt.GF(7), gj.GF(7)
    restore.extend([F7t, F7j])
    _python_mode(F7t, F7j)
    c = [5, 2, 0, 3, 1]  # a feedback polynomial of degree 4 over GF(7)
    lt = gt.FLFSR(gt.Poly(c, field=F7t), state=[1, 2, 3, 4])
    lj = gj.FLFSR(gj.Poly(c, field=F7j), state=[1, 2, 3, 4])
    yt, yj = lt.step(600), lj.step(600)
    assert np.array_equal(np.asarray(yt), np.asarray(yj))
    assert np.array_equal(np.asarray(lt.state), np.asarray(lj.state))
    _same_poly(gt.berlekamp_massey(yt), gj.berlekamp_massey(yj))


@pytest.mark.parametrize("code", ["rs", "bch"])
def test_decoders_match_jax(restore, code):
    make = {"rs": lambda g: g.ReedSolomon(15, 11), "bch": lambda g: g.BCH(15, 7)}[code]
    ct, cj = make(gt), make(gj)
    fields = {ct.field, cj.field, getattr(ct, "extension_field", ct.field), getattr(cj, "extension_field", cj.field)}
    restore.extend(fields)
    _python_mode(*fields)
    rng = np.random.default_rng(9)
    msg = rng.integers(0, ct.field.order, size=(4, ct.k), dtype=np.int64)
    cw = np.asarray(cj.encode(cj.field(msg))).astype(np.int64)
    assert np.array_equal(np.asarray(ct.encode(ct.field(msg))), cw)
    rx = cw.copy()
    for row, n_err in enumerate([0, 1, 2, 3]):
        pos = rng.choice(ct.n, n_err, replace=False)
        rx[row, pos] = (rx[row, pos] + rng.integers(1, ct.field.order, n_err)) % ct.field.order
    (dt, et), (dj, ej) = ct.decode(ct.field(rx), errors=True), cj.decode(cj.field(rx), errors=True)
    assert np.array_equal(np.asarray(dt), np.asarray(dj))
    assert np.array_equal(np.asarray(et), np.asarray(ej))
