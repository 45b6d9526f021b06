"""Element assignment of the torch port against the JAX package.

The same assignments, with the same seeded NumPy values, go to arrays of
``galois_tpu`` and ``galois_tpu_torch`` over every storage kind: int
(GF(2), GF(7), GF(2^8), GF(3^5), GF(2^32 - 5)), planar uint16 limbs
(Goldilocks, GF(2^100)) and planar int64 digits (GF(3^30)). Each case must
give the same integers (exact equality of ``np.asarray``) or raise the same
exception type. The reference's assignment contract: values are checked as
the constructor checks them (``ValueError`` out of range, ``TypeError`` for
floats), and an assignment changes the array assigned to and nothing else.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt

GOLDILOCKS = 2**64 - 2**32 + 1
FIELDS = [2, 7, 2**8, (3, 5), 2**32 - 5, GOLDILOCKS, 2**100, (3, 30)]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _name(q):
    return f"GF({q[0]}^{q[1]})" if isinstance(q, tuple) else f"GF({q})"


@pytest.fixture(params=FIELDS, ids=_name, scope="module")
def fields(request):
    q = request.param
    args = q if isinstance(q, tuple) else (q,)
    return gt.GF(*args), gj.GF(*args)


def _ints(order, shape, seed, low=0):
    """Uniform ints in [low, order) as an object array, from 128 random bits each."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(int(np.prod(shape)), 4), dtype=np.int64)
    vals = [low + (sum(int(w) << (32 * k) for k, w in enumerate(row)) % (order - low)) for row in words]
    return np.array(vals, dtype=object).reshape(shape)


def _outcome(fn):
    """An assignment's result as ints, or the type of what it raised."""
    try:
        return np.asarray(fn(), dtype=object).tolist()
    except Exception as exc:  # noqa: BLE001 -- the exception type is the result
        return type(exc)


def _assign(F, vals, index, value):
    x = F(vals)
    x[index] = value(F) if callable(value) else value
    return x


# (element shape, index, value): a value that is callable gets the field class
CASES = {
    "scalar": ((10,), 0, 1),
    "scalar_negative_index": ((10,), -1, 1),
    "scalar_float": ((10,), 0, 1.0),
    "scalar_out_of_range": ((10,), 0, "order"),
    "slice_constant": ((10,), slice(0, 2), 1),
    "slice_step": ((10,), slice(None, None, 3), 1),
    "slice_list": ((10,), slice(0, 2), [1, 0]),
    "slice_list_float": ((10,), slice(0, 2), [1.0, 1]),
    "slice_list_out_of_range": ((10,), slice(0, 2), ["order", 1]),
    "slice_array_int8": ((10,), slice(0, 2), np.array([1, 1], dtype=np.int8)),
    "slice_array_negative": ((10,), slice(0, 2), np.array([-1, 1], dtype=np.int8)),
    "slice_array_float": ((10,), slice(0, 2), np.array([1.0, 1])),
    "slice_array_out_of_range": ((10,), slice(0, 2), np.array(["order", 1], dtype=object)),
    "field_element": ((10,), 0, lambda F: F(1)),
    "field_slice": ((10,), slice(0, 3), lambda F: F([1, 0, 1])),
    "int_indices": ((10,), np.array([0, 3, 7]), [2, 1, 0]),
    "int_indices_repeat": ((10,), np.array([4, 4]), 1),
    "bool_mask_constant": ((10,), np.arange(10) % 3 == 0, 1),
    "bool_mask_values": ((10,), np.arange(10) % 3 == 0, [1, 0, 1, 1]),
    "2d_slice": ((6, 5), (slice(0, 2), slice(0, 2)), [[1, 1], [1, 0]]),
    "2d_out_of_range": ((6, 5), (slice(0, 2), slice(0, 2)), [["order", 1], [1, 1]]),
    "2d_row": ((6, 5), 1, lambda F: F([1, 0, 1, 0, 1])),
    "2d_column": ((6, 5), (slice(None), 1), 0),
    "2d_element": ((6, 5), (2, 3), 1),
    "2d_ellipsis": ((6, 5), (Ellipsis, 0), [1, 0, 1, 0, 1, 0]),
    "2d_mask": ((6, 5), np.add.outer(np.arange(6), np.arange(5)) % 4 == 0, 1),
    "2d_row_broadcast": ((6, 5), slice(1, 3), [1, 0, 1, 0, 1]),
    "all": ((6, 5), Ellipsis, 1),
}


def _resolve(value, order):
    """Replace the placeholder "order" with the field's order."""
    if isinstance(value, str):
        return order
    if isinstance(value, list):
        return [_resolve(v, order) for v in value]
    if isinstance(value, np.ndarray) and value.dtype == object:
        return np.array([_resolve(v, order) for v in value.tolist()], dtype=object)
    return value


@pytest.mark.parametrize("case", list(CASES))
def test_assignment_matches_jax(fields, case):
    Ft, Fj = fields
    shape, index, value = CASES[case]
    value = _resolve(value, Ft.order)
    vals = _ints(Ft.order, shape, seed=len(case))
    got = _outcome(lambda: _assign(Ft, vals, index, value))
    want = _outcome(lambda: _assign(Fj, vals, index, value))
    assert got == want
    if case == "int_indices":  # a torch index tensor, as the JAX package takes a NumPy one
        assert _outcome(lambda: _assign(Ft, vals, torch.as_tensor(index), value)) == want


def test_assignment_changes_only_the_array_assigned_to(fields):
    """JAX arrays are immutable, so there an assignment gives the array new
    storage: a slice taken before it, an array it was sliced from and the
    tensor an array was made from keep their values. The port gives the
    same answers though its slices are torch views."""
    Ft, Fj = fields
    vals = _ints(Ft.order, (8,), seed=3)
    answers = []
    for F in (Ft, Fj):
        x = F(vals)
        head = x[0:4]
        x[1] = 1  # the slice taken before keeps its values
        head2 = x[0:4]
        head2[2] = 0  # the array it was sliced from keeps its values
        answers.append([np.asarray(a, dtype=object).tolist() for a in (x, head, head2)])
    assert answers[0] == answers[1]
    storage = Ft(vals)._data.clone()
    before = storage.clone()
    y = Ft(storage)
    y[0:3] = 1
    assert torch.equal(storage, before)
    assert np.asarray(y, dtype=object)[:3].tolist() == [1, 1, 1]


def test_assigned_values_go_to_the_arrays_device(fields):
    """The value is made on the array's device, not on the default device:
    with the default set to 'meta', assigning host ints to a CPU array still
    works and leaves its storage on the CPU."""
    Ft, _ = fields
    x = Ft(_ints(Ft.order, (5,), seed=4))
    with gt.default_device("meta"):
        x[1:3] = [1, 0]
        x[np.array([True, False, False, False, True])] = 1
    assert x.device == torch.device("cpu")
    assert np.asarray(x, dtype=object)[[0, 1, 2, 4]].tolist() == [1, 1, 0, 1]
