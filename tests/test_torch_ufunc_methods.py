"""The NumPy ufunc methods of the torch port against the JAX package.

``reduce``, ``accumulate``, ``reduceat``, ``outer`` and ``at`` of the
arithmetic ufuncs, and the ``ValueError`` of every other pair, on the same
seeded NumPy inputs in ``galois_tpu`` and ``galois_tpu_torch`` over every
storage kind (int, planar uint16 limbs, planar int64 digits): the results
must be equal integers (``np.asarray``), of the field's class, or raise the
same exception type. The port runs ``add`` and ``multiply`` ``reduce`` as a
tree of field ops and ``outer`` as one broadcast op on the device, the rest
on exact host ints, as the JAX package routes them.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.fields._hostfield import HostField

from tests.test_torch_setitem import FIELDS, _ints, _name, _outcome


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


@pytest.fixture(params=FIELDS, ids=_name, scope="module")
def fields(request):
    q = request.param
    args = q if isinstance(q, tuple) else (q,)
    return gt.GF(*args), gj.GF(*args)


def _both(fields, call, *shapes, low=1, seed=10):
    """``call(F, *arrays)`` in both packages on the same nonzero ints; the
    results (ints, or the exception type) must agree, and an array result
    must be of the field's class."""
    Ft, Fj = fields
    vals = [_ints(Ft.order, s, seed=seed + k, low=low) for k, s in enumerate(shapes)]
    results = []
    for F in (Ft, Fj):
        out = [None]

        def run():
            out[0] = call(F, *(F(v) for v in vals))
            return out[0]

        results.append(_outcome(run))
        if isinstance(out[0], (gt.FieldArray, gj.FieldArray)):
            assert type(out[0]) is F
    assert results[0] == results[1]
    return results[0]


BINARY = {
    "add": np.add,
    "subtract": np.subtract,
    "multiply": np.multiply,
    "true_divide": np.true_divide,
    "floor_divide": np.floor_divide,
}


@pytest.mark.parametrize("op", list(BINARY))
@pytest.mark.parametrize(
    "shape,kwargs",
    [((10,), {}), ((4, 3), {"axis": 0}), ((4, 3), {"axis": 1, "keepdims": True}), ((2, 3), {})],
    ids=["1d", "axis0", "keepdims", "2d_all"],
)
def test_reduce_matches_jax(fields, op, shape, kwargs):
    _both(fields, lambda F, a: BINARY[op].reduce(a, **kwargs), shape)


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "true_divide"])
@pytest.mark.parametrize("shape,kwargs", [((10,), {}), ((4, 5), {"axis": 1})], ids=["1d", "axis1"])
def test_accumulate_matches_jax(fields, op, shape, kwargs):
    _both(fields, lambda F, a: BINARY[op].accumulate(a, **kwargs), shape)


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "true_divide"])
def test_reduceat_matches_jax(fields, op):
    _both(fields, lambda F, a: BINARY[op].reduceat(a, [1, 4, 5, 8]), (10,))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "true_divide"])
@pytest.mark.parametrize("shapes", [((5,), (4,)), ((2, 3), (4,)), ((3,), (2, 2))], ids=["1x1", "2x1", "1x2"])
def test_outer_matches_jax(fields, op, shapes):
    _both(fields, lambda F, a, b: BINARY[op].outer(a, b), *shapes)


def test_outer_with_a_host_operand_matches_jax(fields):
    _both(fields, lambda F, a: np.multiply.outer(a, [1, 0, 1]), (4,))
    _both(fields, lambda F, a: np.add.outer([0, 1], a), (3,))


@pytest.mark.parametrize("op", ["add", "multiply", "subtract", "true_divide"])
def test_at_matches_jax(fields, op):
    def call(F, a, b):
        BINARY[op].at(a, [0, 3, 3], b)
        return a

    _both(fields, call, (6,), ())


def test_at_without_operand_and_repeated_indices_matches_jax(fields):
    def call(F, a):
        np.multiply.at(a, np.array([1, 1, 4]), F(1))
        np.add.at(a, [2, 2], F(1))
        return a

    _both(fields, call, (6,), low=0)


@pytest.mark.parametrize(
    "call",
    [
        lambda F, a: np.true_divide.reduce(a),
        lambda F, a: np.true_divide.accumulate(a),
        lambda F, a: np.true_divide.reduceat(a, [0, 2]),
        lambda F, a: np.true_divide.outer(a, a),
        lambda F, a: np.floor_divide.outer(a[1:], a),
    ],
    ids=["reduce", "accumulate", "reduceat", "outer", "floor_outer"],
)
def test_zero_divisor_raises_as_in_jax(fields, call):
    Ft, Fj = fields
    vals = np.array([1, 0, 1, 1], dtype=object)
    assert _outcome(lambda: call(Ft, Ft(vals))) is _outcome(lambda: call(Fj, Fj(vals))) is ZeroDivisionError


@pytest.mark.parametrize(
    "call",
    [
        lambda a: np.negative.reduce(a),
        lambda a: np.reciprocal.reduce(a),
        lambda a: np.power.reduce(a),
        lambda a: np.square.reduce(a),
        lambda a: np.log.reduce(a),
        lambda a: np.negative.accumulate(a),
        lambda a: np.power.accumulate(a),
        lambda a: np.log.accumulate(a),
        lambda a: np.square.outer(a, a),
        lambda a: np.power.outer(a, a),
        lambda a: np.negative.at(a, [0]),
        lambda a: np.power.at(a, [0], 2),
    ],
)
def test_unsupported_methods_raise_value_error_as_in_jax(fields, call):
    Ft, Fj = fields
    vals = _ints(Ft.order, (5,), seed=3, low=1)
    assert _outcome(lambda: call(Ft(vals))) is _outcome(lambda: call(Fj(vals))) is ValueError


def test_routes(monkeypatch):
    """add and multiply reduce and every outer stay on the device ops (no
    host field); the other methods run the host field's scalar ops."""
    F = gt.GF(2**8)
    x = F(_ints(256, (8, 8), seed=5, low=1))
    host_calls = []

    for name in ("add", "subtract", "multiply", "divide"):
        fn = getattr(HostField, name)
        monkeypatch.setattr(HostField, name, lambda self, a, b, _fn=fn, _n=name: host_calls.append(_n) or _fn(self, a, b))
    for call in (lambda: np.add.reduce(x, axis=0), lambda: np.multiply.reduce(x), lambda: np.multiply.outer(x, x),
                 lambda: np.true_divide.outer(x[0], x[1])):
        call()
    assert host_calls == []
    np.subtract.reduce(x, axis=1)
    assert host_calls.count("subtract") == 8 * 7


def test_outer_is_the_broadcast_product():
    """A 256 x 256 multiply outer of GF(2^8) is its multiplication table, and
    on the input's device."""
    F = gt.GF(2**8)
    e = F.elements
    table = np.multiply.outer(e, e)
    assert table.shape == (256, 256) and table.device == e.device
    want = np.asarray(gj.GF(2**8).elements)
    jax_table = np.multiply.outer(gj.GF(2**8)(want), gj.GF(2**8)(want))
    assert np.array_equal(np.asarray(table), np.asarray(jax_table))
    assert torch.equal(table._data[7], (e * F(7))._data)
