"""Pickling, element reprs and the display tables of the torch port against
the JAX package.

A pickled field class unpickles as the cached class itself, with the ufunc
mode and element repr it was pickled with; a pickled array comes back equal,
of its class and dtype, on the default device at load time. ``str`` and
``repr`` of arrays in the 'int', 'poly' and 'power' element reprs,
``repr_table`` and ``arithmetic_table`` must be the JAX package's strings,
character for character, on the same seeded NumPy inputs.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt

from tests.test_torch_setitem import FIELDS, _ints, _name


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 -- the exception type is the result
        return type(exc)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


@pytest.fixture(params=FIELDS, ids=_name, scope="module")
def fields(request):
    q = request.param
    args = q if isinstance(q, tuple) else (q,)
    return gt.GF(*args), gj.GF(*args)


@pytest.fixture
def restore(fields):
    """Put the classes' mode and element repr back, as the tests change them."""
    yield
    for F in fields:
        F.compile("auto")
        F.repr("int")


def test_field_class_pickles_as_the_cached_class(fields, restore):
    Ft, _ = fields
    assert pickle.loads(pickle.dumps(Ft)) is Ft
    assert pickle.loads(pickle.dumps(gt.FieldArray)) is gt.FieldArray
    assert pickle.loads(pickle.dumps(gt.Array)) is gt.Array


@pytest.mark.parametrize("mode,element_repr", [("jit-calculate", "poly"), ("python-calculate", "power"), ("auto", "int")])
def test_array_round_trip(fields, restore, mode, element_repr):
    Ft, Fj = fields
    vals = _ints(Ft.order, (3, 4), seed=1)
    x = Ft(vals)
    Ft.compile(mode)
    Ft.repr(element_repr)
    data = pickle.dumps(x)
    Ft.compile("auto")  # unpickling restores the state the class was pickled with
    Ft.repr("int")
    y = pickle.loads(data)
    assert type(y) is Ft and y.dtype == x.dtype
    assert Ft.ufunc_mode == (Ft.default_ufunc_mode if mode == "auto" else mode)
    assert Ft.element_repr == element_repr
    assert np.array_equal(np.asarray(y), np.asarray(x))
    # the JAX package's round trip of the same ints agrees
    Fj.compile(mode)
    Fj.repr(element_repr)
    z = pickle.loads(pickle.dumps(Fj(vals)))
    assert np.array_equal(np.asarray(y), np.asarray(z))
    assert (type(z).ufunc_mode, type(z).element_repr) == (Ft.ufunc_mode, Ft.element_repr)


def test_array_round_trip_keeps_dtype_and_goes_to_the_default_device(fields):
    Ft, _ = fields
    x = Ft(_ints(Ft.order, (5,), seed=2))
    x = x.astype(Ft.dtypes[-1])
    data = pickle.dumps(x[1:4])
    with gt.default_device("meta"):
        y = pickle.loads(data)
    assert type(y) is Ft and y.dtype == x.dtype and y.shape == (3,)
    assert y.device == torch.device("meta")
    assert np.array_equal(np.asarray(pickle.loads(data)), np.asarray(x[1:4]))
    with gt.default_device("meta"):  # copies stay where the array is
        for c in (copy.copy(x), copy.deepcopy(x)):
            assert type(c) is Ft and c.device == x.device and c.dtype == x.dtype
            assert np.array_equal(np.asarray(c), np.asarray(x))


def test_pickle_carries_the_storage_not_python_ints():
    """2^16 GF(2^8) elements pickle as one 64 KiB buffer."""
    x = gt.GF(2**8)(np.arange(2**16) % 256)
    assert len(pickle.dumps(x)) < 2**16 + 1024


@pytest.mark.parametrize("element_repr", ["int", "poly", "power"])
@pytest.mark.parametrize("shape", [(), (5,), (2, 2)], ids=["0d", "1d", "2d"])
def test_str_and_repr_match_jax(fields, restore, element_repr, shape):
    Ft, Fj = fields
    vals = _ints(Ft.order, shape, seed=len(shape))
    if shape == (5,):
        vals[:2] = [0, 1]
    x, y = Ft(vals if shape else int(vals)), Fj(vals if shape else int(vals))
    Ft.repr(element_repr)
    Fj.repr(element_repr)
    assert str(x) == str(y)
    assert repr(x) == repr(y)


def test_repr_is_a_context_manager_and_a_gf_argument(fields, restore):
    Ft, Fj = fields
    args = (Ft.characteristic, Ft.degree)
    vals = [0, 1, Ft.order - 1]
    x = Ft(vals)
    with Ft.repr("poly") as F, Fj.repr("poly"):
        assert F is Ft and Ft.element_repr == "poly"
        assert repr(x) == repr(Fj(vals))
    assert Ft.element_repr == "int" and repr(x) == repr(Fj(vals))
    assert gt.GF(*args, repr="power") is Ft and Ft.element_repr == "power"
    gj.GF(*args, repr="power")
    assert repr(x) == repr(Fj(vals))
    with pytest.raises(ValueError):
        Ft.repr("hex")
    with pytest.raises(ValueError):
        gt.GF(*args, repr="hex")


@pytest.mark.parametrize("order", [2**3, 2**4, 3**2, 7, 5**2])
@pytest.mark.parametrize("sort", ["power", "int"])
def test_repr_table_matches_jax(order, sort):
    assert gt.GF(order).repr_table(sort=sort) == gj.GF(order).repr_table(sort=sort)
    # another primitive element, then 3 (not primitive in GF(5^2): its logs do not exist)
    for element in (int(gj.GF(order).primitive_elements[-1]), 3 if order != 7 else 5):
        want = _outcome(lambda: gj.GF(order).repr_table(element, sort=sort))
        assert _outcome(lambda: gt.GF(order).repr_table(element, sort=sort)) == want


@pytest.mark.parametrize("order", [2**3, 3**2, 7])
@pytest.mark.parametrize("operation", ["+", "-", "*", "/"])
@pytest.mark.parametrize("element_repr", ["int", "poly"])
def test_arithmetic_table_matches_jax(order, operation, element_repr):
    Ft, Fj = gt.GF(order), gj.GF(order)
    try:
        Ft.repr(element_repr)
        Fj.repr(element_repr)
        assert Ft.arithmetic_table(operation) == Fj.arithmetic_table(operation)
        assert Ft.arithmetic_table(operation, x=[1, 2], y=Ft([2, 1])) == Fj.arithmetic_table(operation, x=[1, 2], y=Fj([2, 1]))
    finally:
        Ft.repr("int")
        Fj.repr("int")


def test_table_arguments_raise_as_in_jax():
    for g in (gt, gj):
        with pytest.raises(ValueError):
            g.GF(2**4).repr_table(sort="poly")
        with pytest.raises(ValueError):
            g.GF(2**4).arithmetic_table("**")
