"""FieldArray: the user-facing array class, over a ``torch.Tensor``.

Port of ``galois_tpu/fields/_array.py``. An instance wraps one tensor in the
field's storage (``FieldMeta.torch_dtype``): one integer per element, or
planar words of shape (w, *shape), the storage axis leading: uint16 limbs
for GF(p) with p > 2^32 and GF(2^m) with m > 32 (as in the JAX package),
int64 base-p digits for odd p^m > 2^31 (``fields/_meta.py``); ``shape``,
indexing, reshapes and broadcasting act on the element axes only. Host input goes to the
``device=`` argument or, when it is None, to the package's default device
(``_options.py``, CUDA unless the caller asks for the CPU); every result
stays on its inputs' device. Arithmetic runs eagerly through the ops object
of the field and its ufunc mode (``ops/_kernels.py::get_ops``). The element
functions (``log``, ``sqrt``, ``is_square``, ``additive_order``, ``vector``)
and the metaclass collections (``elements``, ``squares``,
``primitive_elements``, ...) compute on the device where the JAX package
does, and read back one mask or result.

NumPy interop matches the JAX package: ``np.asarray(x)`` gives the integer
representation in the array's dtype (an object array of Python ints for
orders above 2^63), ``np.multiply(x, y)`` and friends
go through ``__array_ufunc__``, and the NumPy functions of
``fields/_np_functions.py`` (``np.fft.fft``, ``np.linalg.inv``, ...) through
``__array_function__``. ``sum``, ``prod`` and ``np.add``/``np.multiply``
``reduce`` reduce with a tree of field adds or multiplies on the array's
device, ``outer`` is one broadcast op there; the other ufunc methods
(``accumulate``, ``reduceat``, ``at``, the other ``reduce`` calls) run on the
exact host field, as in the JAX package. Element assignment gives the array
new storage, so that, as with the JAX package's immutable arrays, no view or
tensor it shares storage with changes. The 'python-calculate' mode computes
the elementwise arithmetic on exact host ints (``_python_op``) and puts the
result back on the operands' device. Arrays pickle with their storage as a
NumPy array (``fields/_factory.py``) and print in the class's element repr
('int', 'poly' or 'power').
"""

from __future__ import annotations

import math
import operator
from typing import Tuple

import numpy as np
import torch

from .._options import resolve_device
from ..polys._conversions import integer_to_poly, poly_to_str, str_to_integer
from ..ops._limbs import _i16, align_planar, normalize_limbs
from ._meta import STORAGE_DIGITS, STORAGE_INT, FieldMeta, int_to_limbs

__all__ = ["Array", "FieldArray", "FieldArrayMeta"]


def _get_ops(field):
    """The ops object of a field class or array, in its kernel mode
    (``ops/_kernels.py::kernel_mode``)."""
    from ..ops._kernels import get_ops, kernel_mode

    return get_ops(field._meta, kernel_mode(field))


def _capturing(data: torch.Tensor) -> bool:
    """Whether work on ``data`` is being recorded into a CUDA graph (the
    current stream is capturing): the port's counterpart of the JAX
    package's ``isinstance(x, jax.core.Tracer)``. A capture cannot hold a
    read-back to the host, so the host checks that the JAX package skips
    under ``jax.jit`` are skipped then too, and the methods that return host
    arrays eagerly return their device tensors."""
    return data.is_cuda and torch.cuda.is_current_stream_capturing()


# ----------------------------------------------------------------------
# Host-side conversion helpers
# ----------------------------------------------------------------------

def _ints_to_storage(meta: FieldMeta, arr: np.ndarray, device=None) -> torch.Tensor:
    """NumPy array of int reprs (any integer or object dtype, values in
    [0, order)) -> storage tensor on ``device`` (None: the default device)."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if meta.storage == STORAGE_INT:
        np_dt = np.uint8 if meta.torch_dtype == torch.uint8 else np.int64
        host = arr.astype(np.int64).astype(np_dt, order="C")
    elif meta.storage == STORAGE_DIGITS:
        host = _ints_to_digits(meta.characteristic, meta.degree, arr)
    else:
        host = _ints_to_limbs(meta.storage_width, arr)
    return torch.from_numpy(host).to(device)


def _ints_to_digits(p: int, m: int, arr: np.ndarray) -> np.ndarray:
    """Int reprs -> planar (m, *shape) int64 base-p digits, ascending: in
    int64 below 2^63, else in object-array ops, one vectorized pass a digit."""
    out = np.empty((m,) + arr.shape, dtype=np.int64)
    v = arr.astype(np.int64) if arr.dtype != object and p**m <= 2**63 else arr.astype(object)
    for k in range(m):
        out[k] = v % p
        v = v // p
    return out


def _ints_to_limbs(L: int, arr: np.ndarray) -> np.ndarray:
    """Int reprs -> planar (L, *shape) uint16 limbs, little-endian. Values
    below 2^64 (L <= 4) split in NumPy uint64; larger ones in object-array
    ops, one vectorized pass per limb."""
    out = np.empty((L,) + arr.shape, dtype=np.uint16)
    if L <= 4:
        x = arr.astype(np.uint64)
        for k in range(L):
            out[k] = (x >> np.uint64(16 * k)) & np.uint64(0xFFFF)
        return out
    v = arr.reshape(-1).astype(object)
    for k in range(L):
        out[k] = (v & 0xFFFF).astype(np.uint16).reshape(arr.shape)
        v = v >> 16
    return out


def _storage_to_ints(meta: FieldMeta, data: torch.Tensor) -> np.ndarray:
    """Storage tensor (any device) -> NumPy array of int reprs: int64, or
    object (Python ints) for orders above 2^63, as the JAX package."""
    host = data.cpu().numpy()
    if meta.storage == STORAGE_INT:
        return host.astype(np.int64)
    if meta.storage == STORAGE_DIGITS:
        p = meta.characteristic
        dt = np.int64 if meta.order <= 2**63 else object
        acc = np.zeros(host.shape[1:], dtype=dt)
        for k in reversed(range(host.shape[0])):
            acc = acc * p + host[k].astype(dt)  # a 0-D object acc becomes a Python int
        return np.asarray(acc, dtype=dt)
    if host.shape[0] <= 4:
        x = np.zeros(host.shape[1:], dtype=np.uint64)
        for k in range(host.shape[0]):
            x |= host[k].astype(np.uint64) << np.uint64(16 * k)
        return x.astype(np.int64) if meta.order <= 2**63 else x.astype(object)
    acc = np.zeros(host.shape[1:], dtype=object)
    for k in reversed(range(host.shape[0])):
        acc = acc * 65536 + host[k].astype(object)
    return np.asarray(acc, dtype=object)


# ----------------------------------------------------------------------
# Metaclass: class-level properties
# ----------------------------------------------------------------------

class FieldArrayMeta(type):
    _meta: FieldMeta

    def __repr__(cls) -> str:
        if cls._meta is None:
            return super().__repr__()
        return f"<class 'galois_tpu_torch.{cls.name}'>"

    @property
    def name(cls) -> str:
        return cls._meta.name

    @property
    def characteristic(cls) -> int:
        return cls._meta.characteristic

    @property
    def degree(cls) -> int:
        return cls._meta.degree

    @property
    def order(cls) -> int:
        return cls._meta.order

    @property
    def irreducible_poly(cls):
        from ..polys._poly import Poly

        return Poly.Int(cls._meta.irreducible_poly_int, field=cls.prime_subfield)

    @property
    def primitive_element(cls) -> "FieldArray":
        return cls(cls._meta.primitive_element_int)

    @property
    def dtypes(cls) -> list:
        return list(cls._meta.dtypes)

    @property
    def default_dtype(cls):
        d = cls._meta.dtypes[0]
        return np.object_ if d is np.object_ else np.dtype(d)

    @property
    def is_prime_field(cls) -> bool:
        return cls._meta.is_prime_field

    @property
    def is_extension_field(cls) -> bool:
        return cls._meta.is_extension_field

    @property
    def prime_subfield(cls):
        from ._factory import GF

        return GF(cls._meta.characteristic)

    @property
    def is_primitive_poly(cls) -> bool:
        """Whether the irreducible polynomial is primitive: x (the element
        p) generates the multiplicative group; always for GF(p)."""
        if cls._meta.degree == 1:
            return True
        from ._hostfield import get_host_field

        return get_host_field(cls._meta).is_primitive_element(cls._meta.characteristic)

    # -- element collections, on the default device --
    @property
    def elements(cls) -> "FieldArray":
        return cls.Range(0, cls.order)

    @property
    def units(cls) -> "FieldArray":
        return cls.Range(1, cls.order)

    @property
    def primitive_elements(cls) -> "FieldArray":
        """alpha^k for every k coprime to q - 1, ascending: for int storage
        one exponent-array power and a sort on the device, else host ints."""
        from ..nt import totatives

        ks = totatives(cls.order - 1)
        if cls._meta.storage == STORAGE_INT:
            pw = cls.primitive_element ** np.asarray(ks, dtype=np.int64)
            return cls._view(torch.sort(pw._data.to(torch.int64)).values.to(cls._meta.torch_dtype))
        from ._hostfield import get_host_field

        hf = get_host_field(cls._meta)
        alpha = cls._meta.primitive_element_int
        return cls(np.array(sorted(hf.power(alpha, k) for k in ks), dtype=object))

    @property
    def normal_element(cls) -> "FieldArray":
        """The smallest normal element of GF(p^m) over GF(p) (a rank test of
        its conjugates' digits, on the host)."""
        from ._normal_element import _conjugate_matrix_rank

        m = cls._meta.degree
        for e in range(1, cls.order):
            if _conjugate_matrix_rank(cls, e) == m:
                return cls(e)
        return None

    @property
    def normal_elements(cls) -> "FieldArray":
        from ._normal_element import _conjugate_matrix_rank

        m = cls._meta.degree
        return cls(np.array([e for e in range(1, cls.order) if _conjugate_matrix_rank(cls, e) == m], dtype=object))

    @property
    def squares(cls) -> "FieldArray":
        x = cls.elements
        return x._masked(x._is_square_data())

    @property
    def non_squares(cls) -> "FieldArray":
        x = cls.elements
        return x._masked(~x._is_square_data())

    @property
    def properties(cls) -> str:
        from ..polys._conversions import integer_to_poly, poly_to_str

        p, meta = cls.characteristic, cls._meta
        alpha = str(meta.primitive_element_int) if meta.degree == 1 else poly_to_str(integer_to_poly(meta.primitive_element_int, p))
        return "\n".join([
            "Galois Field:",
            f"  name: {cls.name}",
            f"  characteristic: {p}",
            f"  degree: {cls.degree}",
            f"  order: {cls.order}",
            f"  irreducible_poly: {poly_to_str(integer_to_poly(meta.irreducible_poly_int, p))}",
            f"  is_primitive_poly: {cls.is_primitive_poly}",
            # the primitive element as a polynomial string for extension
            # fields, as the reference renders it
            f"  primitive_element: {alpha}",
        ])

    @property
    def ufunc_mode(cls) -> str:
        return cls._mode

    @property
    def ufunc_modes(cls) -> list:
        return list(cls._meta.ufunc_modes)

    @property
    def default_ufunc_mode(cls) -> str:
        return cls._meta.default_ufunc_mode

    @property
    def element_repr(cls) -> str:
        return cls._element_repr

    def compile(cls, mode: str) -> None:
        """Select the ufunc mode: 'auto' (the default mode), 'jit-calculate',
        for orders <= 2^20 'jit-lookup' (EXP/LOG table kernels), or
        'python-calculate' (the elementwise arithmetic on exact host ints,
        the result back on the operands' device). The results are
        identical, only the speed differs."""
        if mode == "auto":
            mode = cls._meta.default_ufunc_mode
        if mode not in cls._meta.ufunc_modes:
            raise ValueError(
                f"Argument 'mode' must be in {['auto'] + cls._meta.ufunc_modes}, not {mode!r}."
            )
        cls._mode = mode

    def repr(cls, element_repr: str = "int"):
        """Set how elements print: 'int', 'poly' or 'power'. Also a context
        manager that restores the prior setting on exit."""
        if element_repr not in ("int", "poly", "power"):
            raise ValueError(
                f"Argument 'element_repr' must be in ['int', 'poly', 'power'], not {element_repr!r}."
            )
        prior = cls._element_repr
        cls._element_repr = element_repr

        class _ReprContext:
            def __enter__(self_ctx):
                return cls

            def __exit__(self_ctx, *exc):
                cls._element_repr = prior

        return _ReprContext()

    def _element_to_str(cls, x: int) -> str:
        """An int repr as the tables print it: the int, or for an extension
        field outside int repr its polynomial in α."""
        if cls._element_repr == "int" or cls._meta.degree == 1:
            return str(x)
        return poly_to_str(integer_to_poly(x, cls.characteristic), poly_var="α")


# ----------------------------------------------------------------------
# FieldArray
# ----------------------------------------------------------------------

class Array(metaclass=FieldArrayMeta):
    """Abstract base class of the package's arrays (the reference's
    ``galois.Array``), so that ``isinstance(x, Array)`` and
    ``issubclass(GF, Array)`` behave as in the JAX package."""

    _meta: FieldMeta = None

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Array is abstract; create a concrete field with GF(p**m).")


class FieldArray(Array):
    """An array over GF(p^m). Instances wrap a torch.Tensor in the field's
    storage; the class (manufactured by ``GF()``) carries the static field
    descriptor. ``device`` places host input (None: the package's default
    device); tensor and FieldArray input stays where it is unless ``device``
    is given. A tensor is taken as storage, unverified: int reprs for int
    storage, planar (L, *shape) limbs for limb storage."""

    _meta: FieldMeta = None
    _mode: str = None
    _element_repr: str = "int"

    def __init__(self, x, dtype=None, copy=True, order="K", ndmin=0, *, device=None):
        cls = type(self)
        if cls._meta is None:
            raise NotImplementedError(
                "FieldArray is abstract; create a concrete field with GF(p**m)."
            )
        data = _convert_to_storage(cls, x, device)
        lead = cls._storage_ndim()
        if ndmin and data.ndim - lead < ndmin:
            pad = (1,) * (ndmin - data.ndim + lead)
            data = data.reshape(tuple(data.shape[:lead]) + pad + tuple(data.shape[lead:]))
        self._data = data
        self._dtype = _validate_dtype(cls, dtype)

    @classmethod
    def _view(cls, data: torch.Tensor, dtype=None) -> "FieldArray":
        """Wrap a storage tensor without verification."""
        obj = object.__new__(cls)
        obj._data = data
        obj._dtype = dtype if dtype is not None else cls.default_dtype
        return obj

    @classmethod
    def _storage_ndim(cls) -> int:
        """1 for planar storage (the leading limb or digit axis), else 0."""
        return 0 if cls._meta.storage == STORAGE_INT else 1

    # ------------------------------------------------------------------
    # Alternate constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_numpy(cls, arr: np.ndarray, dtype=None, *, device=None) -> "FieldArray":
        """Integer or object ndarray of int reprs -> FieldArray on ``device``.

        Takes ``np.asarray`` of a ``galois_tpu`` array of the same field (an
        object array of Python ints above order 2^63); the range check and
        the limb split are vectorized, so this is the fast path for large
        host data."""
        arr = np.asarray(arr)
        if arr.dtype != object and not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"{cls.name} arrays must have integer dtypes, not {arr.dtype}.")
        _check_range(cls, arr)
        return cls._view(_ints_to_storage(cls._meta, arr, device), _validate_dtype(cls, dtype))

    @classmethod
    def Zeros(cls, shape, dtype=None, *, device=None) -> "FieldArray":
        full = (cls._meta.storage_width,) * cls._storage_ndim() + _as_shape(shape)
        zeros = torch.zeros(full, dtype=torch.int64, device=resolve_device(device))
        return cls._view(zeros.to(cls._meta.torch_dtype), _validate_dtype(cls, dtype))

    @classmethod
    def Ones(cls, shape, dtype=None, *, device=None) -> "FieldArray":
        return cls._view(_filled(cls, _as_shape(shape), device, "fill_"), _validate_dtype(cls, dtype))

    @classmethod
    def Identity(cls, size: int, dtype=None, *, device=None) -> "FieldArray":
        """The size x size identity, built on ``device``."""
        n = int(size)
        return cls._view(_filled(cls, (n, n), device, "fill_diagonal_"), _validate_dtype(cls, dtype))

    @classmethod
    def Range(cls, start, stop, step=1, dtype=None, *, device=None) -> "FieldArray":
        """The elements with int reprs start, start + step, ... below stop,
        made on ``device`` (int storage by ``torch.arange``)."""
        start, stop, step = int(start), int(stop), int(step)
        if not 0 <= start <= cls.order:
            raise ValueError(f"Argument 'start' must be within the field's order {cls.order}.")
        if stop > cls.order:
            raise ValueError(f"Argument 'stop' must be <= the field order {cls.order}.")
        dtype = _validate_dtype(cls, dtype)
        if cls._meta.storage == STORAGE_INT:
            data = torch.arange(start, stop, step, dtype=torch.int64, device=resolve_device(device))
            return cls._view(data.to(cls._meta.torch_dtype), dtype)
        vals = np.array(list(range(start, stop, step)), dtype=object)
        return cls._view(_ints_to_storage(cls._meta, vals, device), dtype)

    @classmethod
    def Vandermonde(cls, element, rows: int, cols: int, dtype=None, *, device=None) -> "FieldArray":
        """V[i, j] = element^(i j), on ``device`` (by default the element's,
        or the default device)."""
        a = cls(element, device=device)
        if a.ndim != 0:
            raise ValueError("Argument 'element' must be 0-D.")
        e = np.arange(int(rows)).reshape(-1, 1) * np.arange(int(cols)).reshape(1, -1)
        return _power_array(cls._view(a._data), e).astype(_validate_dtype(cls, dtype))

    @classmethod
    def Vector(cls, array, dtype=None, *, device=None) -> "FieldArray":
        """Elements from length-m vectors over GF(p), degrees descending."""
        digits = np.asarray(cls.prime_subfield(array, device="cpu"))
        m = cls._meta.degree
        if digits.shape[-1] != m:
            raise ValueError(f"The last dimension of 'array' must be {m}, not {digits.shape[-1]}.")
        p = cls._meta.characteristic
        ints = np.zeros(digits.shape[:-1], dtype=object)
        for k, col in enumerate(np.moveaxis(digits[..., ::-1].astype(object), -1, 0)):
            ints = ints + col * p**k
        return cls(ints if ints.ndim else int(ints), dtype=dtype, device=device)

    @classmethod
    def Random(
        cls, shape=(), low=0, high=None, seed=None, dtype=None, *, generator=None, device=None
    ) -> "FieldArray":
        """Uniform elements in [low, high) on ``device`` (None: the default
        device). Without a ``generator`` they are drawn on the host by
        ``np.random.default_rng(seed)`` (``seed`` an int, None or a
        ``np.random.Generator``), exactly as the JAX package's ``Random``
        draws them, so the same seed gives the same integers in both
        packages. A ``torch.Generator`` on ``device`` draws them there
        instead, by ``torch.randint`` (limb fields draw their limbs, with
        rejection of the draws at or above high - low)."""
        high = cls.order if high is None else int(high)
        device = resolve_device(device)
        meta = cls._meta
        if generator is None:
            rng = np.random.default_rng(seed)
            data = _seeded_random(meta, int(low), high, _as_shape(shape), rng, device)
            return cls._view(data, _validate_dtype(cls, dtype))
        if seed is not None:
            raise ValueError("Pass either 'seed' (a host draw) or 'generator' (a device draw), not both.")
        if meta.storage == STORAGE_DIGITS:
            data = _random_digits(meta, int(low), high, _as_shape(shape), generator, device)
            return cls._view(data, _validate_dtype(cls, dtype))
        if cls._storage_ndim():
            data = _random_limbs(meta.storage_width, int(low), high, _as_shape(shape), generator, device)
            return cls._view(data.to(meta.torch_dtype), _validate_dtype(cls, dtype))
        data = torch.randint(
            int(low), high, _as_shape(shape), generator=generator, device=device, dtype=torch.int64
        )
        return cls._view(data.to(cls._meta.torch_dtype), _validate_dtype(cls, dtype))

    # ------------------------------------------------------------------
    # Basic array protocol
    # ------------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape[self._storage_ndim() :])

    @property
    def ndim(self) -> int:
        return self._data.ndim - self._storage_ndim()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __getitem__(self, index) -> "FieldArray":
        if self._storage_ndim():
            index = _expand_index(index, self.ndim)
        # through an int16 view: CUDA has no uint16 gather for tensor and mask indices
        return type(self)._view(_i16(self._data)[index].view(self._data.dtype), self._dtype)

    def __setitem__(self, index, value) -> None:
        """Element assignment, with the JAX package's value semantics: the
        array gets new storage, a copy with the values written, so a slice
        taken before and a tensor the array was made from keep their values.
        The value is checked as the constructor checks it (``ValueError``
        out of range, ``TypeError`` for floats) and goes to the array's
        device."""
        value = _convert_to_storage(type(self), value, self.device)
        data = self._data.clone()
        if self._storage_ndim():
            # the storage axis moved last, where the JAX package keeps digits,
            # so that a scalar or (w,) value broadcasts over the element axes;
            # uint16 limbs through int16 views (CUDA has no uint16 scatter)
            target = _i16(data).movedim(0, -1)
            target[_expand_index(index, self.ndim, first=False)] = _i16(value).movedim(0, -1)
        else:
            data[index] = value
        self._data = data

    def reshape(self, *shape) -> "FieldArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        lead = tuple(self._data.shape[: self._storage_ndim()])
        return type(self)._view(self._data.reshape(lead + tuple(int(s) for s in shape)), self._dtype)

    def flatten(self) -> "FieldArray":
        return self.reshape(self.size)

    ravel = flatten

    def transpose(self, *axes) -> "FieldArray":
        """The element axes permuted (reversed when no axes are given)."""
        if not axes:
            return self.T
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        lead = self._storage_ndim()
        perm = tuple(range(lead)) + tuple(lead + int(a) % self.ndim for a in axes)
        return type(self)._view(self._data.permute(perm), self._dtype)

    @property
    def T(self) -> "FieldArray":
        """The element axes reversed (a planar limb axis stays first)."""
        lead = self._storage_ndim()
        axes = tuple(range(lead)) + tuple(lead + a for a in reversed(range(self.ndim)))
        return type(self)._view(self._data.permute(axes), self._dtype)

    def copy(self) -> "FieldArray":
        return type(self)._view(self._data.clone(), self._dtype)

    # copy.copy and copy.deepcopy keep the array's device (pickling goes to the default device)
    def __copy__(self) -> "FieldArray":
        return self.copy()

    def __deepcopy__(self, memo) -> "FieldArray":
        return self.copy()

    def astype(self, dtype) -> "FieldArray":
        return type(self)._view(self._data, _validate_dtype(type(self), dtype))

    def item(self):
        first = self._data.reshape(tuple(self._data.shape[: self._storage_ndim()]) + (-1,))[..., 0]
        return int(_storage_to_ints(self._meta, first))

    def __int__(self):
        if self.ndim != 0:
            raise TypeError("Only 0-D arrays can be converted to int.")
        return self.item()

    def __index__(self):
        return self.__int__()

    def __array__(self, dtype=None, copy=None):
        ints = _storage_to_ints(self._meta, self._data)
        return ints.astype(dtype if dtype is not None else self._dtype)

    # ------------------------------------------------------------------
    # Arithmetic operators
    # ------------------------------------------------------------------

    def _coerce(self, other, for_multiply=False):
        cls = type(self)
        if isinstance(other, FieldArray):
            if type(other)._meta != cls._meta:
                raise TypeError(
                    f"Operands are over different fields: {cls.name} and {type(other).name}."
                )
            return other
        if for_multiply and _is_integer_like(other):
            # An integer operand to multiply is repeated addition: reduce mod p.
            arr = np.asarray(np.asarray(other, dtype=object) % cls._meta.characteristic, dtype=object)
            return cls(arr if arr.ndim else int(arr), device=self.device)
        return cls(other, device=self.device)

    def _binary(self, other, opname, reflected=False, for_multiply=False):
        if not isinstance(other, FieldArray) and not for_multiply:
            # add/subtract/divide require BOTH operands in the field; an
            # integer operand is allowed for multiply only.
            return NotImplemented
        try:
            o = self._coerce(other, for_multiply=for_multiply)
        except (TypeError, ValueError):
            return NotImplemented
        a, b = (o, self) if reflected else (self, o)
        if self._mode == "python-calculate":
            out = _python_op(self._meta, opname, a._data, b._data)
        else:
            # the public elementwise multiply may ride a table kernel (K3 for
            # small odd extension fields); composites keep ops.multiply
            opname = "multiply_bulk" if opname == "multiply" else opname
            out = getattr(_get_ops(self), opname)(a._data, b._data)
        return type(self)._view(out, self._dtype)

    def __add__(self, other):
        return self._binary(other, "add")

    def __radd__(self, other):
        return self._binary(other, "add", reflected=True)

    def __sub__(self, other):
        return self._binary(other, "subtract")

    def __rsub__(self, other):
        return self._binary(other, "subtract", reflected=True)

    def __mul__(self, other):
        return self._binary(other, "multiply", for_multiply=True)

    def __rmul__(self, other):
        return self._binary(other, "multiply", reflected=True, for_multiply=True)

    def __truediv__(self, other):
        if not isinstance(other, FieldArray):
            return NotImplemented
        o = self._coerce(other)
        _check_div_by_zero(o)
        return self._binary(o, "divide")

    def __rtruediv__(self, other):
        _check_div_by_zero(self)
        return self._binary(other, "divide", reflected=True)

    __floordiv__ = __truediv__
    __rfloordiv__ = __rtruediv__

    def __matmul__(self, other):
        from ..ops._linalg import matmul

        return matmul(self, self._coerce(other))

    def __rmatmul__(self, other):
        from ..ops._linalg import matmul

        return matmul(self._coerce(other), self)

    def __neg__(self):
        if self._mode == "python-calculate":
            return type(self)._view(_python_op(self._meta, "negative", self._data), self._dtype)
        return type(self)._view(_get_ops(self).negative(self._data), self._dtype)

    def __pos__(self):
        return self.copy()

    def __pow__(self, other):
        cls = type(self)
        if isinstance(other, (int, np.integer)):
            e = int(other)
            if e < 0:
                _check_div_by_zero(self)
            if cls._mode == "python-calculate":
                return cls._view(_python_op(cls._meta, "power", self._data, e), self._dtype)
            return cls._view(_get_ops(cls).power_static(self._data, e), self._dtype)
        e = np.asarray(other)
        if isinstance(other, FieldArray) or (e.dtype != object and not np.issubdtype(e.dtype, np.integer)):
            raise TypeError(f"Exponents must be integers, not {e.dtype}.")
        return _power_array(self, e)

    def __eq__(self, other):
        try:
            o = self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented
        if self._storage_ndim():
            # planar limbs: align the element axes behind the limb axis
            a, b = align_planar(self._data.to(torch.int32), o._data.to(torch.int32))
            return (a == b).all(dim=0).cpu().numpy()
        return (self._data == o._data).cpu().numpy()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else ~eq

    def _compare(self, other, op):
        """An ordering comparison of the integer representations, computed
        on the device and returned as NumPy bools (np.bool_ for 0-D), as the
        JAX package's ``_compare`` returns them. Int storage compares its
        tensors; planar limbs and digits compare from the most significant
        word down (the sign of a - b is that of its first nonzero word
        difference), the element axes aligned as in ``__eq__``."""
        try:
            o = self._coerce(other)
        except (TypeError, ValueError):
            return NotImplemented
        if self._storage_ndim():
            a, b = align_planar(self._data.to(torch.int64), o._data.to(torch.int64))
            sign = torch.sign(a[-1] - b[-1])
            for k in reversed(range(a.shape[0] - 1)):
                sign = torch.where(sign == 0, torch.sign(a[k] - b[k]), sign)
            out = op(sign, 0).cpu().numpy()
        else:
            out = op(self._data, o._data).cpu().numpy()
        return out if out.ndim else out[()]

    def __lt__(self, other):
        return self._compare(other, operator.lt)

    def __le__(self, other):
        return self._compare(other, operator.le)

    def __gt__(self, other):
        return self._compare(other, operator.gt)

    def __ge__(self, other):
        return self._compare(other, operator.ge)

    def __hash__(self):
        return hash((type(self), self.item())) if self.ndim == 0 else None

    def multiplicative_inverse(self) -> "FieldArray":
        _check_div_by_zero(self)
        if self._mode == "python-calculate":
            return type(self)._view(_python_op(self._meta, "reciprocal", self._data), self._dtype)
        return type(self)._view(_get_ops(self).reciprocal(self._data), self._dtype)

    def log(self, base=None) -> np.ndarray:
        """Discrete logarithm, as an int64 ndarray (base: the primitive
        element unless given): the LOG table through kernel K6 for orders
        <= 2^20, the batched Pohlig-Hellman on the device for larger int
        storage with a smooth q - 1, else the host (``ops/_dlog.py``)."""
        from ..ops._dlog import log as _log

        return _log(self, base)

    def additive_order(self):
        """1 for zero, else the characteristic (an object array of Python
        ints above int64). While capturing, the int64 tensor on the device
        (characteristics below 2^63 only, as in the JAX package's jit)."""
        p = self._meta.characteristic
        capturing = _capturing(self._data)
        if capturing and p > np.iinfo(np.int64).max:
            raise NotImplementedError(f"additive_order under capture requires characteristic < 2^63, not {p}.")
        zero = _get_ops(self).is_zero(self._data)
        if p <= np.iinfo(np.int64).max:
            order = torch.where(zero, 1, p)
            if capturing:
                return order
            out = order.cpu().numpy()
            return out if out.ndim else np.int64(out)
        out = np.full(self.shape, p, dtype=object)
        out[zero.cpu().numpy()] = 1
        return out if out.ndim else int(out)

    def _is_square_data(self) -> torch.Tensor:
        """Euler's criterion on the device: a bool tensor of the element
        shape (every element is a square in characteristic 2)."""
        ops = _get_ops(self)
        zero = ops.is_zero(self._data)
        if self._meta.characteristic == 2:
            return torch.ones_like(zero)
        return zero | ops.is_one(ops.power_static(self._data, (self._meta.order - 1) // 2))

    def is_square(self):
        """Whether each element is a square, as a bool ndarray (np.bool_ for
        a 0-D array); while capturing, the bool tensor on the device."""
        mask = self._is_square_data()
        if _capturing(self._data):
            return mask
        out = mask.cpu().numpy()
        return out if out.ndim else np.bool_(out)

    def sqrt(self) -> "FieldArray":
        """The canonical square roots (int repr <= that of the negation);
        raises ArithmeticError if any element is a non-square. While
        capturing there is no check, and the roots of non-squares are
        unspecified (as under the JAX package's jit)."""
        if not _capturing(self._data) and not bool(self._is_square_data().all()):
            raise ArithmeticError("Input array has elements that are non-squares.")
        if self._mode == "python-calculate":
            return type(self)._view(_python_op(self._meta, "sqrt", self._data), self._dtype)
        return type(self)._view(_get_ops(self).sqrt(self._data), self._dtype)

    def vector(self, dtype=None) -> "FieldArray":
        """The length-m GF(p) vectors of the elements, degrees descending,
        split on the array's device. A prime field on limbs raises
        NotImplementedError while capturing, as under the JAX package's jit."""
        sub = type(self).prime_subfield
        meta = self._meta
        m, p = meta.degree, meta.characteristic
        if m == 1 and meta.storage != STORAGE_INT and _capturing(self._data):
            raise NotImplementedError("vector() of a limb-storage prime field is host-only under capture.")
        if m == 1:  # a prime field: the vector is the element
            return sub._view(self._data.unsqueeze(-1), _validate_dtype(sub, dtype))
        if meta.storage == STORAGE_DIGITS:  # the planar digits, descending, to the last axis
            out = self._data.flip(0).movedim(0, -1).contiguous()
            return sub._view(out.to(sub._meta.torch_dtype), _validate_dtype(sub, dtype))
        if meta.storage != STORAGE_INT:  # GF(2^m) on limbs: the bits, descending
            w = self._data.to(torch.int64)
            bits = [(w[k // 16] >> (k % 16)) & 1 for k in reversed(range(m))]
            return sub._view(torch.stack(bits, dim=-1).to(torch.uint8), _validate_dtype(sub, dtype))
        x = self._data.to(torch.int64)
        digs = []
        for _ in range(m):
            digs.append(x % p)
            x = x // p
        out = torch.stack(digs[::-1], dim=-1).to(sub._meta.torch_dtype)
        return sub._view(out, _validate_dtype(sub, dtype))

    def _masked(self, mask: torch.Tensor) -> "FieldArray":
        """The elements where the element mask holds, as a 1-D array."""
        if self._storage_ndim():
            return type(self)._view(_i16(self._data)[:, mask].view(self._data.dtype), self._dtype)
        return type(self)._view(self._data[mask], self._dtype)

    def _reduce(self, opname: str, axis=None) -> "FieldArray":
        """Field sum or product over one element axis (all of them when
        ``axis`` is None), as a tree of field adds or multiplies on the
        array's device."""
        from ..ops._linalg import _field_reduce

        cls = type(self)
        lead = self._storage_ndim()
        data = self._data
        if axis is None:
            data, dim = data.reshape(tuple(data.shape[:lead]) + (-1,)), lead
        else:
            dim = lead + int(axis) % self.ndim
        op = getattr(_get_ops(cls), opname)
        return cls._view(_field_reduce(op, data, dim), self._dtype)

    def sum(self, axis=None) -> "FieldArray":
        return self._reduce("add", axis)

    def prod(self, axis=None) -> "FieldArray":
        return self._reduce("multiply", axis)

    def dot(self, other) -> "FieldArray":
        from ..ops._linalg import matmul

        return matmul(self, self._coerce(other))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        name = ufunc.__name__
        if method == "reduce" and name in ("add", "multiply") and not kwargs.get("keepdims"):
            recv = next(x for x in inputs if isinstance(x, FieldArray))
            return recv._reduce(name, kwargs.get("axis", None))
        if method != "__call__":
            return _ufunc_method(ufunc, method, inputs, kwargs)
        if name in ("add", "subtract", "true_divide", "divide", "floor_divide"):
            if not all(isinstance(x, FieldArray) for x in inputs):
                raise TypeError(
                    f"Operation {name!r} requires both operands to be instances of "
                    f"{type(self).name}, not {[type(x).__name__ for x in inputs]}. "
                    "Integer operands are only allowed for 'multiply' (repeated "
                    "addition) and 'power'."
                )
        binary = {
            "add": lambda a, b: a._binary(b, "add"),
            "subtract": lambda a, b: a._binary(b, "subtract"),
            "multiply": lambda a, b: a._binary(b, "multiply", for_multiply=True),
            "true_divide": lambda a, b: a.__truediv__(b),
            "divide": lambda a, b: a.__truediv__(b),
            "floor_divide": lambda a, b: a.__truediv__(b),
            "power": lambda a, b: a.__pow__(b),
            "matmul": lambda a, b: a.__matmul__(b),
        }
        unary = {
            "negative": lambda a: -a,
            "positive": lambda a: +a,
            "reciprocal": lambda a: a.multiplicative_inverse(),
            "square": lambda a: a * a,
            "sqrt": lambda a: a.sqrt(),
            "log": lambda a: a.log(),
        }
        if name in binary:
            a, b = inputs
            if not isinstance(a, FieldArray):
                a = b._coerce(a, for_multiply=(name == "multiply"))
            return binary[name](a, b)
        if name in unary:
            return unary[name](inputs[0])
        raise NotImplementedError(
            f"NumPy ufunc {name!r} is not supported on {type(self).name} arrays in the torch port."
        )

    def __array_function__(self, func, types, args, kwargs):
        from . import _np_functions

        return _np_functions.dispatch(self, func, args, kwargs)

    # ------------------------------------------------------------------
    # Display
    # ------------------------------------------------------------------

    def _format_element(self, x: int) -> str:
        """One int repr in the class's element repr: the int, its polynomial
        in α, or α^i by the host discrete log (``ops/_dlog.py::host_log``)."""
        cls = type(self)
        if cls._element_repr == "int":
            return str(x)
        if cls._element_repr == "poly":
            return poly_to_str(integer_to_poly(x, self._meta.characteristic), poly_var="α")
        if x == 0:
            return "0"
        from ..ops._dlog import host_log

        i = host_log(self._meta, x)
        return "1" if i == 0 else ("α" if i == 1 else f"α^{i}")

    def __repr__(self) -> str:
        return self._to_string(repr_mode=True)

    def __str__(self) -> str:
        return self._to_string(repr_mode=False)

    def _to_string(self, repr_mode: bool) -> str:
        arr = _storage_to_ints(self._meta, self._data)
        if not arr.shape:
            body = self._format_element(int(arr))
        elif type(self)._element_repr == "int":
            body = np.array2string(arr, separator=", ")
        else:
            strs = np.empty(arr.shape, dtype=object)
            for idx in np.ndindex(arr.shape):
                strs[idx] = self._format_element(int(arr[idx]))
            body = np.array2string(strs, separator=", ", formatter={"all": str})
        return f"GF({body}, order={self._meta.order})" if repr_mode else body


# ----------------------------------------------------------------------
# Power with integer-array exponents
# ----------------------------------------------------------------------

def _power_array(x: FieldArray, e: np.ndarray) -> FieldArray:
    """x ** e for an integer ndarray exponent of any magnitude and sign (on
    host ints in 'python-calculate'): e is reduced mod q-1 on the host, in NumPy for integer dtypes (a
    non-negative int64 exponent of a field with q - 1 >= 2^63 is its own
    residue) and in Python ints otherwise. Int storage passes the reduced
    exponent as one int64 tensor, planar storage as 62-bit words."""
    cls = type(x)
    meta = cls._meta
    q1 = meta.order - 1
    nbits = max(1, q1.bit_length())
    ops = _get_ops(cls)
    if (e < 0).any():
        _check_div_by_zero(x)
    if cls._mode == "python-calculate":
        return cls._view(_python_op(meta, "power", x._data, e), x._dtype)
    red = None
    if e.dtype != object:
        if np.issubdtype(e.dtype, np.unsignedinteger):
            red = e.astype(np.uint64) % np.uint64(q1) if q1 < 2**64 else e.astype(np.uint64)
        elif q1 < 2**63:
            red = e.astype(np.int64) % q1
        elif not (e < 0).any():
            red = e.astype(np.int64)
    if red is not None and meta.storage == STORAGE_INT:
        out = ops.power(x._data, torch.as_tensor(red.astype(np.int64, copy=False), device=x.device), nbits=nbits)
    elif red is not None:
        nbits = min(nbits, 64)
        t = red.dtype.type
        words = [((red >> t(s)) & t(2**62 - 1)).astype(np.int64) for s in range(0, nbits, 62)]
        out = ops.power_words(x._data, [torch.as_tensor(w, device=x.device) for w in words], nbits)
    else:
        red = np.frompyfunc(lambda v: int(v) % q1, 1, 1)(e.astype(object))
        words = []
        for s in range(0, nbits, 62):
            w = np.frompyfunc(lambda v: (v >> s) & (2**62 - 1), 1, 1)(red)
            words.append(torch.as_tensor(np.asarray(w).astype(np.int64), device=x.device))
        out = ops.power_words(x._data, words, nbits) if len(words) > 1 else ops.power(x._data, words[0], nbits)
    # 0^e = 0 for e != 0 (the reduction mod q-1 may have zeroed e).
    zero_fix = ops.is_zero(x._data) & torch.as_tensor(e != 0, device=x.device)
    return cls._view(ops.zero_where(zero_fix, out), x._dtype)


# ----------------------------------------------------------------------
# The ufunc methods and the python-calculate mode
# ----------------------------------------------------------------------

_UFUNC_OPS = {  # ufunc -> (the host field's op, the operator of the device route)
    "add": ("add", operator.add),
    "subtract": ("subtract", operator.sub),
    "multiply": ("multiply", operator.mul),
    "true_divide": ("divide", operator.truediv),
    "floor_divide": ("divide", operator.truediv),
    "divide": ("divide", operator.truediv),
}


def _ufunc_method(ufunc, method, inputs, kwargs):
    """reduce, accumulate, reduceat, outer and at of the four arithmetic
    ufuncs, as in the JAX package. ``outer`` is one broadcast operation on
    the operands' device (the field's own multiply kernel reads the
    operands by stride); the others run a ``np.frompyfunc`` ufunc of the
    exact host field, which gives NumPy's semantics of every method (axis,
    indices, ``at`` in place), and their result goes back to the input's
    device. A zero divisor raises ``ZeroDivisionError`` on either route."""
    name = ufunc.__name__
    if name not in _UFUNC_OPS or method not in ("reduce", "accumulate", "reduceat", "outer", "at"):
        raise ValueError(
            f"Ufunc method {method!r} is not supported on {name!r}. Only '__call__' is supported."
        )
    opname, op = _UFUNC_OPS[name]
    recv = next(x for x in inputs if isinstance(x, FieldArray))
    cls, device = type(recv), recv.device
    if method == "outer":
        a, b = (x if isinstance(x, FieldArray) else cls(x, device=device) for x in inputs)
        return op(cls._view(a._data.reshape(tuple(a._data.shape) + (1,) * b.ndim)), b)
    from ._hostfield import get_host_field

    fn = np.frompyfunc(getattr(get_host_field(cls._meta), opname), 2, 1)

    def host(x):
        return np.asarray(x if isinstance(x, FieldArray) else cls(x, device="cpu"), dtype=object)

    if method == "at":
        a = inputs[0]
        arr = host(a)
        fn.at(arr, inputs[1], *(host(v) for v in inputs[2:]))
        a[...] = cls(arr, device=a.device)  # NumPy's `at` works in place
        return None
    if method == "reduceat":
        out = fn.reduceat(host(inputs[0]), np.asarray(inputs[1], dtype=np.intp), **kwargs)
    else:
        out = getattr(fn, method)(host(inputs[0]), **kwargs)
    return cls(out if isinstance(out, np.ndarray) else int(out), device=device)


def _python_op(meta: FieldMeta, opname: str, *args) -> torch.Tensor:
    """The python-calculate mode's elementwise op ('add', 'subtract',
    'multiply', 'divide', 'negative', 'reciprocal', 'sqrt', 'power') on
    exact host ints: the storage tensors in ``args`` come to the host (a
    power's exponent is an int or an integer ndarray), broadcast as NumPy
    does, and the result goes back to the first one's device."""
    from ._hostfield import get_host_field

    hf = get_host_field(meta)
    fn = (lambda a: _host_sqrt(hf, a)) if opname == "sqrt" else getattr(hf, opname)
    ints = [
        _storage_to_ints(meta, a).astype(object) if isinstance(a, torch.Tensor) else np.asarray(a, dtype=object)
        for a in args
    ]
    out = np.frompyfunc(fn, len(ints), 1)(*ints)
    return _ints_to_storage(meta, np.asarray(out, dtype=object), args[0].device)


def _host_sqrt(hf, a: int) -> int:
    """The canonical square root (the smaller int repr of r and -r) of one
    host int: one power for characteristic 2 and q = 3 mod 4, Atkin for
    q = 5 mod 8, else Tonelli-Shanks."""
    q = hf.q
    if a == 0:
        return 0
    if hf.p == 2:
        return hf.power(a, q // 2)
    if q % 4 == 3:
        r = hf.power(a, (q + 1) // 4)
    elif q % 8 == 5:
        # Atkin: t = (2a)^((q-5)/8), i = 2a t^2, root = a t (i - 1)
        a2 = hf.add(a, a)
        t = hf.power(a2, (q - 5) // 8)
        i_val = hf.multiply(a2, hf.multiply(t, t))
        r = hf.multiply(hf.multiply(a, t), hf.subtract(i_val, 1))
    else:
        Q, S = q - 1, 0
        while Q % 2 == 0:
            Q //= 2
            S += 1
        c = hf.power(hf.find_non_square(), Q)
        t = hf.power(a, Q)
        r = hf.power(a, (Q + 1) // 2)
        M = S
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = hf.multiply(tt, tt)
                i += 1
            b = c
            for _ in range(M - i - 1):
                b = hf.multiply(b, b)
            r = hf.multiply(r, b)
            c = hf.multiply(b, b)
            t = hf.multiply(t, c)
            M = i
    return min(r, hf.negative(r))


# ----------------------------------------------------------------------
# Helpers
# ----------------------------------------------------------------------

def _expand_index(index, ndim: int, first: bool = True):
    """An index of the element axes -> an index of planar storage whose
    storage axis leads (``first``) or, moved there, trails: that axis is
    kept whole, and an ellipsis is expanded so that it cannot swallow it."""
    if not isinstance(index, tuple):
        index = (index,)
    if any(ix is Ellipsis for ix in index):
        pos = index.index(Ellipsis)
        n_specified = sum(1 for ix in index if ix is not None and ix is not Ellipsis)
        index = index[:pos] + (slice(None),) * (ndim - n_specified) + index[pos + 1 :]
    return (slice(None),) + index if first else index + (slice(None),)


def _seeded_random(meta: FieldMeta, low: int, high: int, shape, rng: np.random.Generator, device) -> torch.Tensor:
    """The JAX package's ``Random`` draw, as storage on ``device``: for
    orders up to 2^63 ``rng.integers(low, high)`` in int64; above, low + v
    (high - low) // 2^62 for each element's v = ``rng.integers(0, 2^62)``,
    the v drawn by one call (the same stream as the JAX package's call an
    element) and scaled into limbs on ``device`` (``_scaled_limbs``; digit
    fields in Python ints on the host)."""
    if meta.order <= 2**63:
        return _ints_to_storage(meta, rng.integers(low, high, size=shape, dtype=np.int64), device)
    span = high - low
    if span < 1:
        raise ValueError(f"Argument 'high' must be larger than 'low', not {high} <= {low}.")
    v = rng.integers(0, 2**62, size=math.prod(shape))
    if meta.storage == STORAGE_DIGITS:
        return _ints_to_storage(meta, (low + v.astype(object) * span // 2**62).reshape(shape), device)
    limbs = _scaled_limbs(torch.from_numpy(v).to(device), span, low, meta.storage_width)
    return limbs.reshape((meta.storage_width,) + tuple(shape)).to(meta.torch_dtype)


def _scaled_limbs(v: torch.Tensor, span: int, low: int, L: int) -> torch.Tensor:
    """low + v span // 2^62 for int64 v in [0, 2^62), as (L, n) int64 16-bit
    limbs: the product in columns of limbs (four terms of < 2^32 a column),
    carried, shifted right by 62 bits and added to low's limbs."""
    vl = [(v >> (16 * i)) & 0xFFFF for i in range(4)]
    sl = int_to_limbs(span, -(-span.bit_length() // 16)).tolist()
    cols = [torch.zeros_like(v) for _ in range(4 + len(sl) + 1)]
    for j, s in enumerate(sl):
        for i in range(4):
            if s:
                cols[i + j] += vl[i] * s
    carry = torch.zeros_like(v)
    for k in range(len(cols)):
        t = cols[k] + carry
        cols[k], carry = t & 0xFFFF, t >> 16
    cols.append(torch.zeros_like(v))
    out, carry = [], torch.zeros_like(v)
    for t, lo in enumerate(int_to_limbs(low, L).tolist()):
        q = ((cols[3 + t] >> 14) | (cols[4 + t] << 2) & 0xFFFF) if 4 + t < len(cols) else torch.zeros_like(v)
        t_sum = q + lo + carry
        out.append(t_sum & 0xFFFF)
        carry = t_sum >> 16
    return torch.stack(out)


def _random_limbs(L: int, low: int, high: int, shape, generator, device) -> torch.Tensor:
    """Uniform int reprs in [low, high) as int64 limbs (L, *shape), drawn on
    ``device``: limbs of span - 1's bit length, and redraws of the values at
    or above the span (fewer than half of them per round)."""
    span = high - low
    if span < 1:
        raise ValueError(f"Argument 'high' must be larger than 'low', not {high} <= {low}.")
    bits = (span - 1).bit_length()
    masks = torch.tensor([(1 << min(max(bits - 16 * k, 0), 16)) - 1 for k in range(L)], device=device)
    # one limb more than the values: the span of GF(2^16k) is 2^16k
    span_limbs = torch.tensor(int_to_limbs(span, L + 1), device=device).reshape(L + 1, 1)

    def draw(n):
        r = torch.randint(0, 2**16, (L, n), generator=generator, device=device, dtype=torch.int64)
        return r & masks.reshape(L, 1)

    def at_or_above_span(v):
        v = torch.cat([v, torch.zeros_like(v[:1])])
        return normalize_limbs(v - span_limbs)[1] == 0  # no borrow out of v - span

    v = draw(math.prod(shape))
    bad = at_or_above_span(v)
    while bool(bad.any()):
        idx = bad.nonzero().reshape(-1)
        v[:, idx] = draw(idx.numel())
        bad = torch.zeros_like(bad)
        bad[idx] = at_or_above_span(v[:, idx])
    v, _ = normalize_limbs(v + torch.tensor(int_to_limbs(low, L), device=device).reshape(L, 1))
    return v.reshape((L,) + tuple(shape))


def _random_digits(meta: FieldMeta, low: int, high: int, shape, generator, device) -> torch.Tensor:
    """Uniform int reprs in [low, high) as planar digits (m, *shape): the
    whole field draws each digit on ``device``; a narrower range draws its
    limbs there and splits them into digits there too below 2^63, on the
    host above."""
    p, m = meta.characteristic, meta.degree
    if (low, high) == (0, meta.order):
        return torch.randint(0, p, (m,) + tuple(shape), generator=generator, device=device, dtype=torch.int64)
    L = -(-(high - 1).bit_length() // 16)
    limbs = _random_limbs(L, low, high, shape, generator, device)
    if meta.order <= 2**63:
        v = sum(limbs[k] << (16 * k) for k in range(L))
        digits = []
        for _ in range(m):
            digits.append(v % p)
            v = v // p
        return torch.stack(digits)
    ints = np.zeros(tuple(shape), dtype=object)
    for k in reversed(range(L)):
        ints = ints * 65536 + limbs[k].cpu().numpy().astype(object)
    return torch.from_numpy(_ints_to_digits(p, m, np.asarray(ints, dtype=object))).to(device)


def _filled(cls, shape, device, fill: str) -> torch.Tensor:
    """Storage of zeros of element ``shape`` on ``device`` whose int reprs
    (limb 0 of planar limbs) then get ``fill`` with 1: ``fill_`` for ones,
    ``fill_diagonal_`` for an identity."""
    lead = cls._storage_ndim()
    data = torch.zeros((cls._meta.storage_width,) * lead + shape, dtype=torch.int64, device=resolve_device(device))
    getattr(data[0] if lead else data, fill)(1)
    return data.to(cls._meta.torch_dtype)


def _as_shape(shape) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _validate_dtype(cls, dtype):
    if dtype is None:
        return cls.default_dtype
    if dtype is np.object_ or np.dtype(dtype) == np.dtype(object):
        if np.object_ not in cls._meta.dtypes:
            raise TypeError(f"Argument 'dtype' must be in {cls.dtypes}, not object.")
        return np.object_
    dt = np.dtype(dtype)
    if not any(dt == np.dtype(d) for d in cls._meta.dtypes if d is not np.object_):
        raise TypeError(
            f"Argument 'dtype' must be in {[np.dtype(d).name for d in cls._meta.dtypes]}, "
            f"not {dt.name!r}."
        )
    return dt


def _is_integer_like(x) -> bool:
    if isinstance(x, (int, np.integer)):
        return True
    if isinstance(x, np.ndarray):
        if np.issubdtype(x.dtype, np.integer):
            return True
        if x.dtype == object:
            return all(isinstance(v, (int, np.integer)) for v in x.reshape(-1))
    return False


def _check_range(cls, arr: np.ndarray) -> None:
    """Raise ValueError naming the first value outside [0, order); object
    arrays must hold integers."""
    flat = arr.reshape(-1)
    if arr.dtype == object:
        if not all(isinstance(v, (int, np.integer)) for v in flat):
            raise TypeError(f"{cls.name} arrays must hold integers.")
        order = cls._meta.order
        bad = [int(v) for v in flat[np.asarray((flat < 0) | (flat >= order), dtype=bool)][:1]]
    elif np.iinfo(arr.dtype).max < cls._meta.order:  # only negatives can be out of range
        bad = flat[flat < 0][:1].tolist()
    else:
        bad = flat[(flat < 0) | (flat >= cls._meta.order)][:1].tolist()
    if bad:
        raise ValueError(
            f"{cls.name} arrays must have values in [0, {cls._meta.order}), not {bad[0]}."
        )


def _convert_to_storage(cls, x, device) -> torch.Tensor:
    """Convert array-like input to a verified storage tensor."""
    meta = cls._meta
    if isinstance(x, FieldArray):
        if type(x)._meta != meta:
            raise TypeError(f"Cannot convert {type(x).name} array to {cls.name}.")
        return x._data.to(device) if device is not None else x._data
    if isinstance(x, torch.Tensor):
        # Trusted device input, not verified: int reprs in [0, order), or
        # planar limbs with the leading limb axis.
        if cls._storage_ndim() and (x.ndim < 1 or x.shape[0] != meta.storage_width):
            raise ValueError(
                f"Tensor input to {cls.name} must have a leading (planar) limb axis of length "
                f"{meta.storage_width}, not shape {tuple(x.shape)}."
            )
        data = x.to(meta.torch_dtype)
        return data.to(device) if device is not None else data
    arr = _parse_host(cls, x)
    return _ints_to_storage(meta, arr, device)


def _parse_host(cls, x) -> np.ndarray:
    """Host input -> a NumPy array of int reprs, range-checked. Strings are
    polynomials in x or α over the prime subfield ("x^2 + 1", "α^2 + α"),
    alone or as elements of (nested) lists."""
    if isinstance(x, str):
        arr = np.array(str_to_integer(x, cls._meta.characteristic), dtype=object)
    elif isinstance(x, (list, tuple)):
        arr = np.array(_parse_nested(cls, x), dtype=object)
    elif isinstance(x, (int, np.integer)):
        arr = np.array(int(x), dtype=object)
    elif isinstance(x, np.ndarray):
        if x.dtype != object and not np.issubdtype(x.dtype, np.integer):
            raise TypeError(f"{cls.name} arrays must have integer dtypes, not {x.dtype}.")
        arr = x
    else:
        raise TypeError(f"Cannot convert {type(x)} to {cls.name}.")
    _check_range(cls, arr)
    return arr


def _parse_nested(cls, x):
    if isinstance(x, (list, tuple)):
        return [_parse_nested(cls, v) for v in x]
    if isinstance(x, str):
        return str_to_integer(x, cls._meta.characteristic)
    if isinstance(x, FieldArray):
        return int(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, np.ndarray):
        return x.astype(object).tolist()
    raise TypeError(f"Cannot convert element {type(x)} to {cls.name}.")


def _check_div_by_zero(x: FieldArray):
    """Raise ZeroDivisionError if x holds a 0 (no check while capturing)."""
    if not _capturing(x._data) and bool(_get_ops(x).is_zero(x._data).any()):
        raise ZeroDivisionError("Cannot compute the multiplicative inverse of 0 in a Galois field.")
