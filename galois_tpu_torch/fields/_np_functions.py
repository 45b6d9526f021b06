"""NumPy ``__array_function__`` dispatch for FieldArrays.

The port has ``np.convolve``, ``np.fft.fft`` and ``np.fft.ifft``, as in
``galois_tpu/fields/_np_functions.py``; the rest of that table (linear
algebra, dot products, reductions, shape pass-throughs) is still to be
ported.
"""

from __future__ import annotations

import numpy as np


def dispatch(self, func, args, kwargs):
    if func is np.convolve:
        from ..ops._convolve import convolve

        return convolve(*args, **kwargs)
    if func in (np.fft.fft, np.fft.ifft):
        from ..ops._ntt import field_fft, field_ifft

        fn = field_fft if func is np.fft.fft else field_ifft
        return fn(*args, **kwargs)
    name = getattr(func, "__name__", str(func))
    raise NotImplementedError(
        f"NumPy function {name!r} is not ported to the torch FieldArray yet "
        "(the rest of fields/_np_functions.py). Use np.asarray(x) for a plain array."
    )
