"""The port's CUDA-graph capture branch against the JAX package under jax.jit.

Where the JAX package sees a tracer (``jax.jit``), it skips its host checks
and returns device arrays; the port does the same while the current CUDA
stream is capturing (``fields/_array.py::_capturing``). On the CPU there is
no capture, so these tests patch the helper to report one and run the same
calls: arithmetic (``a * b + a``, ``a / b``, ``a ** 3``, ``np.reciprocal``)
over main path 11's fields (GF(2^8), GF(2^16) in lookup mode, GF(2^31 - 1),
the Goldilocks field, GF(2^128), GF(3^5)) and GF(31), and the methods of the JAX package's jit tests (``field_trace``,
``field_norm``, ``vector``, ``additive_order``, ``multiplicative_order``,
``log``, ``plu_decompose``, ``is_square``, ``sqrt``), over GF(2^8), GF(31),
GF(3^5) and the Goldilocks field. The same inputs, made with numpy from a
seed, go through ``jax.jit`` of the JAX package's call; the tolerance is
exact integer equality, and where the JAX package raises under jit the
port must raise the same exception type. Each call runs once eagerly first
(as a capture is warmed up), then under a guard that fails on anything a
capture cannot hold: a read-back to the host, a tensor made from host data,
a mask index. The kernels' plain versions, which on the card give way to
the kernels, are exempt.
"""

import contextlib
import functools
import sys

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.fields import _array

GOLDILOCKS = 2**64 - 2**32 + 1
F128 = "x^128 + x^7 + x^2 + x + 1"
ORDERS = [2**8, 31, 3**5, GOLDILOCKS]
# (order, irreducible polynomial, mode): the fields whose arithmetic main path 11 captures on the card
ARITHMETIC_FIELDS = [(2**8, None, "auto"), (2**16, None, "jit-lookup"), (2**31 - 1, None, "auto"),
                     (GOLDILOCKS, None, "auto"), (2**128, F128, "auto"), (3**5, None, "auto"), (31, None, "auto")]
N = 16


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


# what a capture cannot hold: host read-backs, tensors from host data, mask and list indices
_SYNCS = {"__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy", "nonzero", "tensor"}


def _in_plain_version() -> bool:
    """Whether a kernel's plain version is on the stack: it serves CPU
    tensors only, and on the card its kernel runs instead."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.endswith("_plain"):
            return True
        frame = frame.f_back
    return False


class _NoHostWork(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if _in_plain_version():
            return func(*args, **(kwargs or {}))
        if name in _SYNCS or (name == "as_tensor" and not isinstance(args[0], torch.Tensor)):
            raise AssertionError(f"{name} would read back or copy host data under capture")
        if name in ("__getitem__", "__setitem__"):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            for ix in index:
                if isinstance(ix, (list, np.ndarray)) or (isinstance(ix, torch.Tensor) and ix.dtype == torch.bool):
                    raise AssertionError(f"{name} with a {type(ix).__name__} index syncs under capture")
        return func(*args, **(kwargs or {}))


def _from_numpy_forbidden(*args):
    raise AssertionError("from_numpy would copy host data under capture")


@contextlib.contextmanager
def _captured(monkeypatch):
    """The port's capture branch, with every host sync an error."""
    with monkeypatch.context() as m:
        m.setattr(_array, "_capturing", lambda data: True)
        m.setattr(torch, "from_numpy", _from_numpy_forbidden)
        with _NoHostWork():
            yield


@functools.cache
def _fields(q, f=None):
    """The two packages' classes of one field (cached: a given irreducible
    polynomial is tested at every GF call)."""
    kw = {} if f is None else {"irreducible_poly": f}
    return gj.GF(q, **kw), gt.GF(q, **kw)


def _inputs(q, seed, low=0):
    rng = np.random.default_rng(seed)
    if q > 2**63:
        return np.array([low + int(v) * (q - low) // 2**62 for v in rng.integers(0, 2**62, N)], dtype=object)
    return rng.integers(low, q, N, dtype=np.int64)


def _ints(x):
    """A result as a NumPy int array: a FieldArray's int reprs, a tensor's values."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x, dtype=object)


def _same(port, ref):
    if isinstance(ref, tuple):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)
        return
    a, b = _ints(port), np.asarray(ref, dtype=object)
    assert a.shape == b.shape and (a.astype(object) == b).all()


ARITHMETIC = {
    "a * b + a": lambda a, b: a * b + a,
    "a / b": lambda a, b: a / b,
    "a ** 3": lambda a, b: a**3,
    "reciprocal": lambda a, b: np.reciprocal(b),
}
METHODS = {
    "field_trace": lambda x: x.field_trace(),
    "field_norm": lambda x: x.field_norm(),
    "vector": lambda x: x.vector(),
    "additive_order": lambda x: x.additive_order(),
    "multiplicative_order": lambda x: x.multiplicative_order(),
    "log": lambda x: x.log(),
    "plu_decompose": lambda x: x.reshape(4, 4).plu_decompose(),
    "is_square": lambda x: x.is_square(),
    "sqrt": lambda x: (x * x).sqrt(),
}


def _jit_or_error(fn, *args):
    try:
        return jax.jit(fn)(*args), None
    except NotImplementedError as e:
        return None, type(e)


@pytest.mark.parametrize("name", list(ARITHMETIC))
@pytest.mark.parametrize(["q", "f", "mode"], ARITHMETIC_FIELDS, ids=[f"{q}-{m}" for q, _, m in ARITHMETIC_FIELDS])
def test_arithmetic_under_capture_matches_jit(q, f, mode, name, monkeypatch):
    Fj, Ft = _fields(q, f)
    a, b = _inputs(q, 1), _inputs(q, 2, low=1)
    fn = ARITHMETIC[name]
    Fj.compile(mode)
    Ft.compile(mode)
    try:
        ref = jax.jit(fn)(Fj(a), Fj(b))
        x, y = Ft(a), Ft(b)
        _same(fn(x, y), ref)
        with _captured(monkeypatch):
            out = fn(x, y)
    finally:
        Fj.compile("auto")
        Ft.compile("auto")
    _same(out, ref)


@pytest.mark.parametrize("name", list(METHODS))
@pytest.mark.parametrize("q", ORDERS)
def test_methods_under_capture_match_jit(q, name, monkeypatch):
    Fj, Ft = _fields(q)
    a = _inputs(q, 3, low=1)  # nonzero: log and multiplicative_order are unspecified at 0 under jit
    fn = METHODS[name]
    ref, err = _jit_or_error(fn, Fj(a))
    x = Ft(a)
    if err is None:
        fn(x)  # warm up, as a capture is
    with _captured(monkeypatch):
        if err is not None:
            with pytest.raises(err):
                fn(x)
            return
        out = fn(x)
    if name in ("additive_order", "multiplicative_order", "log", "is_square"):
        # jit gives device arrays where the eager call gives host ones: so does capture
        assert isinstance(out, torch.Tensor)
        assert out.dtype == (torch.bool if name == "is_square" else torch.int64)
    _same(out, ref)


@pytest.mark.parametrize("q", ORDERS)
def test_checks_are_skipped_under_capture(q, monkeypatch):
    """A zero divisor, log(0), the order of 0 and the root of a non-square
    raise eagerly; under capture, as under jit, the calls return unchecked.
    Each call runs first on units (or squares), to warm up its route."""
    _, Ft = _fields(q)
    x = Ft(_inputs(q, 4, low=1))
    zero = Ft.Zeros(N)
    calls = [(lambda z: x / z, zero), (lambda z: z**-1, zero), (lambda z: np.reciprocal(z), zero)]
    if q != GOLDILOCKS:  # its log and multiplicative_order raise NotImplementedError under capture
        calls += [(lambda z: z.log(), zero), (lambda z: z.multiplicative_order(), zero)]
    if q % 2:
        calls.append((lambda z: z.sqrt(), x[~x.is_square()][:1]))
    for call, bad in calls:
        call(x * x)
        with pytest.raises((ZeroDivisionError, ArithmeticError)):
            call(bad)
        with _captured(monkeypatch):
            call(bad)


def test_capture_raises_where_jit_raises(monkeypatch):
    """The limb and host routes that the JAX package refuses under jit."""
    Fg = gt.GF(GOLDILOCKS)
    x = Fg(_inputs(GOLDILOCKS, 5, low=1))
    Fb = gt.GF(2**64 + 13)  # characteristic above 2^63
    y = Fb([1, 2])
    with _captured(monkeypatch):
        for call in (x.vector, x.multiplicative_order, x.log, y.additive_order):
            with pytest.raises(NotImplementedError):
                call()


def test_capture_helper_is_false_off_capture():
    assert not _array._capturing(torch.zeros(3))
