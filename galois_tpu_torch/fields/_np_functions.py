"""NumPy ``__array_function__`` dispatch for FieldArrays.

Port of ``galois_tpu/fields/_np_functions.py``, the whole table:
``np.convolve``, ``np.fft.fft``/``ifft``, ``np.matmul``/``dot``, ``inner``,
``outer``, ``vdot``, ``np.sum``/``prod``, ``np.linalg.det``, ``inv``,
``solve``, ``matrix_rank`` and ``matrix_power``, and the shape
pass-throughs. Everything but the pass-throughs runs on the array's device.
The pass-throughs run on the int representation in host NumPy, as the JAX
package runs them, and put their result on the dispatching array's device;
``np.trace`` is a field sum of the diagonal on the device. Any other NumPy
function raises ``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

# Shape-manipulation functions that work on the int representation and can
# be reconstructed without re-verification (the JAX package's table).
_PASSTHROUGH = {
    np.reshape, np.ravel, np.transpose, np.concatenate, np.stack,
    np.vstack, np.hstack, np.dstack, np.column_stack, np.atleast_1d,
    np.atleast_2d, np.atleast_3d, np.squeeze, np.expand_dims, np.tile,
    np.repeat, np.roll, np.flip, np.fliplr, np.flipud, np.rot90,
    np.broadcast_to, np.split, np.array_split, np.hsplit, np.vsplit,
    np.dsplit, np.swapaxes, np.moveaxis, np.delete, np.insert, np.append,
    np.trace, np.tril, np.triu, np.diag, np.diagonal, np.sort, np.unique,
    np.count_nonzero, np.array_equal, np.allclose, np.isclose,
    np.may_share_memory, np.shares_memory, np.copy, np.resize,
}
# Pass-throughs whose result is not an array of the field.
_RAW_RESULT = {
    np.count_nonzero, np.array_equal, np.allclose, np.isclose, np.may_share_memory, np.shares_memory,
}


def dispatch(self, func, args, kwargs):
    from ..ops import _linalg

    cls = type(self)
    name = getattr(func, "__name__", str(func))

    if func is np.convolve:
        from ..ops._convolve import convolve

        return convolve(*args, **kwargs)
    if func in (np.fft.fft, np.fft.ifft):
        from ..ops._ntt import field_fft, field_ifft

        fn = field_fft if func is np.fft.fft else field_ifft
        return fn(*args, **kwargs)
    if func is np.matmul or func is np.dot:
        a, b = (cls(x, device=self.device) for x in args)
        if a.ndim == 0 or b.ndim == 0:
            return a * b
        return _linalg.matmul(a, b)
    if func is np.inner:
        a, b = args
        if a.ndim == 1 and b.ndim == 1:
            return _linalg.matmul(cls(a, device=self.device), cls(b, device=self.device))
        raise NotImplementedError(f"NumPy function {name!r} is not supported on FieldArrays.")
    if func is np.outer:
        a, b = (cls(x, device=self.device).flatten() for x in args)
        return a.reshape(a.size, 1) * b.reshape(1, b.size)
    if func is np.vdot:
        a, b = (cls(x, device=self.device).flatten() for x in args)
        return _linalg.matmul(a, b)
    if func is np.sum:
        return args[0].sum(axis=kwargs.get("axis", args[1] if len(args) > 1 else None))
    if func is np.prod:
        return args[0].prod(axis=kwargs.get("axis", args[1] if len(args) > 1 else None))
    if func is np.linalg.det:
        return _linalg.det(args[0])
    if func is np.linalg.inv:
        return _linalg.inv(args[0])
    if func is np.linalg.solve:
        return _linalg.solve(*args)
    if func is np.linalg.matrix_rank:
        return _linalg.matrix_rank(args[0])
    if func is np.linalg.matrix_power:
        A, n = args
        return _matrix_power(A, int(n))
    if func is np.trace:
        # a field sum of the diagonal (of the first two axes), on the device
        A = args[0]
        lead = A._storage_ndim()
        diag = A._data.diagonal(dim1=lead, dim2=lead + 1)
        ops = _linalg.get_ops(cls._meta, _linalg.kernel_mode(cls))
        return cls._view(_linalg._field_reduce(ops.add, diag, diag.ndim - 1), A._dtype)
    if func in _PASSTHROUGH:
        from ._array import FieldArray

        def unwrap(x):
            if isinstance(x, FieldArray):
                return np.asarray(x, dtype=np.int64 if cls._meta.order <= 2**63 else object)
            if isinstance(x, (tuple, list)):
                return type(x)(unwrap(v) for v in x)
            return x

        out = func(*[unwrap(a) for a in args], **{k: unwrap(v) for k, v in kwargs.items()})
        if func in _RAW_RESULT:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(cls(o, device=self.device) for o in out)
        return cls(out, device=self.device)

    raise NotImplementedError(f"NumPy function {name!r} is not supported on {cls.name} arrays.")


def _matrix_power(A, n: int):
    from ..ops import _linalg

    cls = type(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise np.linalg.LinAlgError("matrix_power requires a square matrix.")
    if n < 0:
        A = _linalg.inv(A)
        n = -n
    result = cls.Identity(A.shape[0], device=A.device)
    base = A
    while n:
        if n & 1:
            result = _linalg.matmul(result, base)
        base = _linalg.matmul(base, base)
        n >>= 1
    return result
