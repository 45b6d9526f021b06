"""Elementwise field arithmetic on storage tensors.

Port of the int-storage families of ``galois_tpu/ops/_kernels.py``:

- ``PrimeOps``      GF(p), p <= 2^32, int64 (or uint8) storage; the
                    multiply of GF(2^31 - 1) is kernel K9
                    (``ops/_elementwise.py::m31_multiply``)
- ``GF2Ops``        GF(2), bitwise
- ``BinaryExtOps``  GF(2^m), m <= 32; the multiply is kernel K8 for
                    2 <= m <= 8 (``ops/_elementwise.py::gf2m_multiply_swar``,
                    uint8 storage, by the field's tables) and kernel K7 for
                    9 <= m <= 16 (``gf2m_multiply``), a torch ladder above;
                    reciprocal and powers for 2 <= m <= 16 are kernel K8-A
                    (``gf2m_power``, by the field's tables), torch chains
                    above; K8, K8-A and K8-B share one table per (m, f,
                    device) (``packed_tables``), the one that lookup mode
                    reads for that field
- ``OddExtOps``     GF(p^m), p odd, p^m <= 2^31: base-p digit arithmetic;
                    the public multiply of orders <= 4096 is kernel K3
- ``LookupOps``     the 'jit-lookup' mode of any field of order <= 2^20:
                    multiply, divide, reciprocal and log are kernels K3-K6
                    (``ops/_lookup.py``), powers plain torch gathers
- ``LimbPrimeOps``  GF(p), p > 2^32, planar (L, ...) uint16 limb storage:
                    schoolbook products and Barrett reduction on int64
                    planes of 16-bit limbs
- ``GoldilocksOps`` p = 2^64 - 2^32 + 1: the multiply and square are kernel
                    K10 (``ops/_elementwise.py::goldilocks_multiply``)
- ``LimbBinaryOps`` GF(2^m), m > 32, planar (L, ...) uint16 limbs of the
                    coefficient bits: XOR adds; multiply, square and every
                    power are kernel K14 (``ops/_limb_binary.py``)
- ``DigitExtOps``   GF(p^m), p odd, p^m > 2^31, planar (m, ...) int64
                    base-p digits: digitwise adds, the digit convolution
                    and reduction-matrix fold (plain torch, as jnp in the
                    JAX package)

The three planar kinds share ``PlanarOps``: masks over the leading storage
axis, constants filled word by word, the exponent ladders.

Every family has ``sqrt``, the canonical square root (the one whose int
repr is <= that of its negation, as the JAX package): one ``power_static``
for q = 3 mod 4 and for characteristic 2 (K8-A for GF(2^m <= 16)), Atkin
for q = 5 mod 8, else Tonelli-Shanks as fixed trip counts of masked
selects; lookup mode reads LOG by K6.

Every op takes and returns tensors in the field's storage dtype and keeps
its inputs' device. Arithmetic is widened to int64 inside each op: torch
has no unsigned 16/32-bit arithmetic, and uint8 sums wrap. Dispatch
depends on the field and mode only; the kernel wrappers alone look at the
device.

The JAX package's limb-tuple protocol (``split_limbs``/``*_t``), its MXU
diagonal fold for L > 4 and its compact fori_loop powers exist for the TPU's
lanes and XLA's compile times; eager torch needs none of them, so the limb
families work on the storage tensor directly and ``power_static`` is the
plain square-and-multiply.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields._hostfield import get_host_field
from ..fields._meta import STORAGE_DIGITS, STORAGE_LIMBS, FieldMeta, int_to_limbs
from ..fields._tables import build_exp_log
from ._elementwise import (
    GOLDILOCKS_P,
    M31,
    gf2m_multiply,
    gf2m_multiply_swar,
    gf2m_power,
    gf2m_reduce_plain,
    gf2m_square_plain,
    goldilocks_multiply,
    itoh_tsujii,
    m31_multiply,
    power_ladder,
)
from ._limb_binary import gf2_limb_multiply, gf2_limb_power, gf2_limb_square
from ._limbs import _i16, _where, align_planar, mul_limbs, normalize_limbs, planar_power_words
from ._lookup import (
    field_tables,
    gf2m_packed_tables,
    lookup_divide,
    lookup_log,
    lookup_multiply,
    lookup_reciprocal,
    pack_tables,
)

__all__ = ["get_ops", "FieldOps", "mulmod"]


def mulmod(a, b, p: int):
    """(a * b) mod p for int64 tensors (b may be a Python int) holding values
    in [0, p), p < 2^32.

    int64 products overflow once (p - 1)^2 >= 2^63, which includes the NTT
    prime 3 * 2^30 + 1. Then b is split into 16-bit halves: a * b_hi and
    a * b_lo stay below 2^48, and so does (a * b_hi mod p) * 2^16."""
    if (p - 1) ** 2 < 2**63:
        return a * b % p
    b_hi, b_lo = b >> 16, b & 0xFFFF
    return ((a * b_hi) % p * 65536 + a * b_lo) % p


class FieldOps:
    """Base class: square-and-multiply powers and derived ops."""

    def __init__(self, meta: FieldMeta):
        self.meta = meta
        self.dt = meta.torch_dtype

    # subclasses: add, subtract, negative, multiply, reciprocal

    def square(self, a):
        return self.multiply(a, a)

    def divide(self, a, b):
        return self.multiply(a, self.reciprocal(b))

    def multiply_bulk(self, a, b):
        """Elementwise multiply as the public ``*`` dispatches it: the same
        map as ``multiply``, which a family may route to a table kernel
        while composites (powers, transforms) keep ``multiply``."""
        return self.multiply(a, b)

    def power_static(self, a, e: int):
        """a**e for a Python-int exponent (any size and sign)."""
        if e < 0:
            return self.power_static(self.reciprocal(a), -e)
        if e == 0:
            return self.one_like(a)
        result = None
        for bit in bin(e)[2:]:
            if result is not None:
                result = self.square(result)
            if bit == "1":
                result = a if result is None else self.multiply(result, a)
        return result

    def power(self, a, e, nbits: int):
        """a**e for a non-negative int64 exponent tensor below 2^nbits:
        a binary ladder over the exponent's bits (0**0 = 1)."""
        return power_ladder(a, e, nbits, self.one_like, self.square, self.multiply)

    def one_like(self, a):
        return torch.ones_like(a)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def is_zero(self, a):
        return a == 0

    def zero_where(self, mask, a):
        """a with the elements where ``mask`` holds set to 0."""
        return torch.where(mask, torch.zeros_like(a), a)

    def is_one(self, a):
        return a == 1

    def const_like(self, a, value: int):
        """The element with int repr ``value`` in a's storage, shape and
        device (filled on the device: no copy from the host)."""
        return torch.full_like(a, value)

    def select(self, mask, x, y):
        """x where the element mask holds, else y (uint16 limbs included)."""
        return _where(mask, x, y)

    def repr_le(self, a, b):
        """Mask: the int repr of a is <= that of b."""
        return a <= b

    def sqrt(self, a):
        """A square root of each element: the canonical one, whose int repr
        is <= that of its negation (the JAX package's choice). For
        non-squares the result is unspecified; callers check ``is_square``
        first. Characteristic 2: a^(2^(m-1)), one ``power_static``."""
        q, p = self.meta.order, self.meta.characteristic
        if p == 2:
            return self.power_static(a, q // 2)
        if q % 4 == 3:
            root = self.power_static(a, (q + 1) // 4)
        elif q % 8 == 5:
            # Atkin: t = (2a)^((q-5)/8), i = 2a t^2, root = a t (i - 1)
            a2 = self.add(a, a)
            t = self.power_static(a2, (q - 5) // 8)
            i_val = self.multiply(a2, self.square(t))
            root = self.multiply(self.multiply(a, t), self.subtract(i_val, self.one_like(a)))
        else:
            root = self._tonelli_shanks(a)
        neg = self.negative(root)
        return self.select(self.repr_le(root, neg), root, neg)

    def _tonelli_shanks(self, a):
        """Tonelli-Shanks with the JAX package's fixed trip counts (q - 1 =
        Q 2^S): S rounds, each S masked squarings to find the least i with
        t^(2^i) = 1 and S masked squarings for b = c^(2^(m - i - 1)). Every
        step is a select on the device: nothing is read back. The
        non-square z is the primitive element (its log, 1, is odd)."""
        q = self.meta.order
        Q, S = q - 1, 0
        while Q % 2 == 0:
            Q //= 2
            S += 1
        z = self.meta.primitive_element_int
        t = self.power_static(a, Q)
        r = self.power_static(a, (Q + 1) // 2)
        c = self.const_like(a, get_host_field(self.meta).power(z, Q))
        m_cur = torch.full(self.is_zero(a).shape, S, dtype=torch.int64, device=a.device)
        for _ in range(S):
            tt, i_found, done = t, torch.zeros_like(m_cur), self.is_one(t)
            for i in range(1, S + 1):
                tt = self.square(tt)
                hit = ~done & self.is_one(tt)
                i_found = torch.where(hit, i, i_found)
                done = done | hit
            shift = m_cur - i_found - 1
            b = c
            for j in range(S):
                b = self.select(shift > j, self.square(b), b)
            finished = i_found == 0
            r = self.select(finished, r, self.multiply(r, b))
            c_new = self.square(b)
            t = self.select(finished, t, self.multiply(t, c_new))
            c = self.select(finished, c, c_new)
            m_cur = torch.where(finished, m_cur, i_found)
        return r


# ======================================================================
# GF(p), p <= 2^32
# ======================================================================

class PrimeOps(FieldOps):
    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic

    def add(self, a, b):
        s = a.to(torch.int64) + b.to(torch.int64)
        return torch.where(s >= self.p, s - self.p, s).to(self.dt)

    def negative(self, a):
        aw = a.to(torch.int64)
        return torch.where(aw == 0, aw, self.p - aw).to(self.dt)

    def subtract(self, a, b):
        d = a.to(torch.int64) - b.to(torch.int64)
        return torch.where(d < 0, d + self.p, d).to(self.dt)

    def multiply(self, a, b):
        if self.p == M31:
            # the map of the JAX package's _mul_mersenne31 (its Pallas
            # counterpart prime_multiply_pallas), here kernel K9
            return m31_multiply(a, b)
        return mulmod(a.to(torch.int64), b.to(torch.int64), self.p).to(self.dt)

    def reciprocal(self, a):
        return self.power_static(a, self.p - 2)


class GF2Ops(PrimeOps):
    """GF(2): pure bitwise ops."""

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        return a & b

    def reciprocal(self, a):
        return a

    def divide(self, a, b):
        return a & b

    def power(self, a, e, nbits: int):
        a, e = torch.broadcast_tensors(a, e)
        return torch.where(e == 0, torch.ones_like(a), a)

    def power_static(self, a, e: int):
        return torch.ones_like(a) if e == 0 else a


# ======================================================================
# GF(2^m), m <= 32
# ======================================================================

class BinaryExtOps(FieldOps):
    """GF(2^m) on int storage. Dispatch is by field only, so CPU tensors
    follow the card's routing: products to K8 (m <= 8) or K7 (m <= 16);
    reciprocals and powers to K8-A (m <= 16); larger m to torch ladders."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.m = meta.degree
        self.f = meta.irreducible_poly_int

    def add(self, a, b):
        return a ^ b

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        if self.m <= 8:
            return gf2m_multiply_swar(a, b, self.m, self.f)
        if self.m <= 16:
            return gf2m_multiply(a, b, self.m, self.f)
        # the carry-less product of int64 tensors (2m - 1 <= 63 bits), reduced
        aw, bw = a.to(torch.int64), b.to(torch.int64)
        acc = torch.zeros_like(aw)
        for i in range(self.m):
            acc = acc ^ ((aw << i) & -((bw >> i) & 1))
        return gf2m_reduce_plain(acc, self.m, self.f).to(self.dt)

    def square(self, a):
        return gf2m_square_plain(a, self.m, self.f)

    def packed_tables(self, device: torch.device) -> torch.Tensor:
        """This field's EXP and LOG on ``device`` in ``pack_tables``' layout
        for its storage (m <= 16): the table K8, K8-A and K8-B stage, one per
        (m, f, device) (``_lookup.gf2m_packed_tables``)."""
        return gf2m_packed_tables(self.m, self.f, torch.device(device))

    def reciprocal(self, a):
        if self.m <= 16:
            return gf2m_power(a, None, self.m, self.f)
        return itoh_tsujii(a, self.m, self.square, self.multiply)

    def power(self, a, e, nbits: int):
        if self.m <= 16:
            return gf2m_power(a, e, self.m, self.f, nbits)
        return super().power(a, e, nbits)

    def power_static(self, a, e: int):
        if self.m > 16 or e <= 0:
            return super().power_static(a, e)  # e < 0 inverts first
        # a^e = a^e' with e' = e mod (2^m - 1) in [1, 2^m - 1], for every a
        e_red = (e - 1) % (2**self.m - 1) + 1
        e_t = torch.full((), e_red, dtype=torch.int64, device=a.device)  # no copy from the host
        return gf2m_power(a, e_t, self.m, self.f, self.m)


# ======================================================================
# GF(p^m), p odd, int storage (p^m <= 2^31)
# ======================================================================

class _Tables:
    """A field's EXP (length 2(q-1)) and LOG (length q) as int32 NumPy
    arrays, and their copies on each device they are used on, with the
    packed table K3-K6 read there (``_lookup.pack_tables``). The field's own
    tables (``exp`` and ``log`` not given) come from the one cache per field
    and device, ``_lookup.field_tables``; tables installed by the caller
    are copied here."""

    def __init__(self, meta: FieldMeta, exp=None, log=None):
        q = meta.order
        self._own = exp is None
        if self._own:
            exp, log = build_exp_log(meta)
        exp, log = np.asarray(exp), np.asarray(log)
        if exp.shape != (2 * (q - 1),) or log.shape != (q,) or not np.array_equal(exp[: q - 1], exp[q - 1 :]):
            raise ValueError(
                f"{meta.name} needs EXP of length {2 * (q - 1)}, its first q - 1 entries twice, and LOG "
                f"of length {q}, not {exp.shape} and {log.shape}."
            )
        self.meta = meta
        self.EXP = exp.astype(np.int32)
        self.LOG = log.astype(np.int32)
        self._on = {}

    def on(self, device: torch.device):
        """(EXP, LOG) on ``device``."""
        return self._device(device)[:2]

    def packed(self, device: torch.device):
        """K3-K6's table for this field's storage on ``device``."""
        return self._device(device)[2]

    def _device(self, device):
        if self._own:
            return field_tables(self.meta, torch.device(device))
        if device not in self._on:
            exp_t, log_t = (torch.from_numpy(t).to(device) for t in (self.EXP, self.LOG))
            packed = pack_tables(exp_t, log_t, self.meta.order, self.meta.torch_dtype)
            self._on[device] = (exp_t, log_t, packed)
        return self._on[device]


@functools.lru_cache(maxsize=None)
def _reduction_rows(meta: FieldMeta, device: torch.device) -> torch.Tensor:
    """The field's (m - 1, m) reduction matrix (x^(m + k) mod f) on ``device``."""
    return torch.from_numpy(np.asarray(meta.reduction_matrix)).to(device)


def digit_product(A, B, meta: FieldMeta):
    """GF(p^m) product of planar int64 base-p digits A (m, *sa) and B
    (m, *sb) with aligned element axes: the digit convolution, then the
    fold of the m - 1 high digits by the reduction matrix, as the JAX
    package's ``_mul_digits``. Where m (p - 1)^2 < 2^62 the sums need one
    ``% p`` after each stage; larger p take ``mulmod`` and a ``% p`` a term."""
    p, m = meta.characteristic, meta.degree
    wide = m * (p - 1) ** 2 < 2**62

    def mul(x, y):
        return x * y if wide else mulmod(x, y, p)

    shape = torch.broadcast_shapes(A.shape[1:], B.shape[1:])
    full = torch.zeros((2 * m - 1,) + tuple(shape), dtype=torch.int64, device=A.device)
    for i in range(m):
        full[i : i + m] += mul(A[i : i + 1], B)
        if not wide:
            full[i : i + m] %= p
    full %= p
    R = _reduction_rows(meta, A.device).reshape((m - 1, m) + (1,) * len(shape))
    low = full[:m]
    for k in range(m - 1):
        low = low + mul(full[m + k : m + k + 1], R[k])
        if not wide:
            low = low % p
    return low % p


class OddExtOps(FieldOps):
    """Base-p digit arithmetic on int storage, digits split on the fly into
    planar (m, *shape) tensors, as ``DigitExtOps`` stores them.

    p^m <= 2^31 with m >= 2 gives p < 2^16, so in int64 a digit product is
    below 2^32 and a sum of m of them below 2^37: one ``% p`` after the
    convolution and one after the fold by the reduction matrix are exact.
    (The JAX package's three u32 regimes exist for the TPU.)"""

    # Orders whose public multiply rides the table kernel K3 (the JAX
    # package's multiply_bulk rule, galois_tpu/ops/_kernels.py:928).
    BULK_LOOKUP_MAX_ORDER = 4096

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic
        self.m = meta.degree
        self._weights = [self.p**i for i in range(self.m)]

    def _digits(self, a):
        x = a.to(torch.int64)
        digs = []
        for _ in range(self.m):
            digs.append(x % self.p)
            x = x // self.p
        return torch.stack(digs)

    def _undigits(self, d):
        out = d[0].clone()
        for i in range(1, self.m):
            out += d[i] * self._weights[i]
        return out.to(self.dt)

    def _digits2(self, a, b):
        return align_planar(self._digits(a), self._digits(b))

    def add(self, a, b):
        A, B = self._digits2(a, b)
        return self._undigits((A + B) % self.p)

    def negative(self, a):
        return self._undigits((-self._digits(a)) % self.p)

    def subtract(self, a, b):
        A, B = self._digits2(a, b)
        return self._undigits((A - B) % self.p)

    def multiply(self, a, b):
        return self._undigits(digit_product(*self._digits2(a, b), self.meta))

    @functools.cached_property
    def _tables(self) -> _Tables:
        return _Tables(self.meta)

    def multiply_bulk(self, a, b):
        if self.meta.order <= self.BULK_LOOKUP_MAX_ORDER:
            exp_t, log_t = self._tables.on(a.device)
            return lookup_multiply(a, b, exp_t, log_t, self.meta.order, self._tables.packed(a.device))
        return self.multiply(a, b)

    def reciprocal(self, a):
        return self.power_static(a, self.meta.order - 2)


# ======================================================================
# Lookup-table mode (order <= 2^20, int storage)
# ======================================================================

class LookupOps:
    """The 'jit-lookup' ops of a field: EXP/LOG table kernels K3-K6 for
    multiply, divide, reciprocal and log (and LOG for sqrt), plain torch
    gathers for powers;
    everything else delegates to the field's calculate ops.

    Every order <= 2^20 takes the kernels, whatever the array size: the
    JAX package's TPU routing (orders above 2^12 to the calculate kernels,
    arrays below 2^13 elements to XLA gathers) answers XLA's gather lowering
    and Mosaic's 128-entry chunks. The H100's 50 MB L2 holds the largest
    table (12 MB). Results are identical either way."""

    def __init__(self, calc: FieldOps):
        self._calc = calc
        self.meta = calc.meta
        self.dt = calc.dt
        self._tables = _Tables(self.meta)

    def __getattr__(self, name):
        return getattr(self._calc, name)

    def load_tables(self, exp, log) -> None:
        """Install host tables (e.g. the JAX package's ``LookupOps.EXP`` and
        ``LookupOps.LOG`` for the same field) in place of this object's own;
        they are copied to each device at its first use."""
        self._tables = _Tables(self.meta, exp, log)

    @property
    def EXP(self) -> np.ndarray:
        return self._tables.EXP

    @property
    def LOG(self) -> np.ndarray:
        return self._tables.LOG

    def multiply(self, a, b):
        exp_t, log_t = self._tables.on(a.device)
        return lookup_multiply(a, b, exp_t, log_t, self.meta.order, self._tables.packed(a.device))

    def multiply_bulk(self, a, b):
        # without this override __getattr__ would hand out the calculate
        # ops' multiply_bulk and leave lookup mode
        return self.multiply(a, b)

    def square(self, a):
        return self.multiply(a, a)

    def divide(self, a, b):
        exp_t, log_t = self._tables.on(a.device)
        return lookup_divide(a, b, exp_t, log_t, self.meta.order, self._tables.packed(a.device))

    def reciprocal(self, a):
        exp_t, log_t = self._tables.on(a.device)
        return lookup_reciprocal(a, exp_t, log_t, self.meta.order, self._tables.packed(a.device))

    def log_alpha(self, a):
        """Discrete log base the field's primitive element (int64)."""
        _, log_t = self._tables.on(a.device)
        return lookup_log(a, log_t, self.meta.order, self._tables.packed(a.device))

    def sqrt(self, a):
        """The canonical square root through the tables, LOG read by K6:
        alpha^(LOG a * q/2 mod (q - 1)) for even q (q/2 inverts 2 mod the
        odd q - 1); for odd q alpha^(LOG a / 2) or its negation, whichever
        int repr is smaller; 0 for 0."""
        q = self.meta.order
        exp_t, _ = self._tables.on(a.device)
        la = self.log_alpha(a)
        if q % 2 == 0:
            r = exp_t[la * (q // 2) % (q - 1)].to(self.dt)
        else:
            r1 = exp_t[la // 2].to(self.dt)
            r2 = self._calc.negative(r1)
            r = torch.where(r1 <= r2, r1, r2)
        return torch.where(a == 0, torch.zeros_like(r), r)

    def power(self, a, e, nbits: int = None):
        """a**e for an int64 exponent tensor: alpha^(LOG[a] * e mod (q-1)),
        with 0**0 = 1 and 0**e = 0 otherwise."""
        q1 = self.meta.order - 1
        exp_t, log_t = self._tables.on(a.device)
        a, e = torch.broadcast_tensors(a, e.to(torch.int64))
        idx = log_t[a.long()].long() * (e % q1) % q1
        r = exp_t[idx].to(torch.int64)
        r = torch.where(a == 0, (e == 0).to(torch.int64), r)
        return r.to(self.dt)

    def power_static(self, a, e: int):
        """a**e for a Python-int exponent; a negative one inverts first."""
        if e < 0:
            return self.power_static(self.reciprocal(a), -e)
        q1 = self.meta.order - 1
        r = self.power(a, torch.tensor(e % q1, device=a.device))
        if e != 0 and e % q1 == 0:
            r = torch.where(a == 0, torch.zeros_like(r), r)
        return r


# ======================================================================
# Planar storage: (w, *shape), the limb or digit axis leading
# ======================================================================

class PlanarOps(FieldOps):
    """What the three planar kinds share (limbs of GF(p), p > 2^32, limbs of
    GF(2^m), m > 32, digits of odd p^m > 2^31): element masks reduce over the
    leading storage axis, constants fill word by word on the device, and
    the exponent ladders broadcast the element axes behind it."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.L = meta.storage_width

    def _const_words(self, value: int):
        return int_to_limbs(value, self.L)

    def one_like(self, a):
        one = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        one[0].fill_(1)  # no host copy of the scalar, so no wait for the card
        return one.to(self.dt)

    def zero_like(self, a):
        return torch.zeros(a.shape, dtype=torch.int64, device=a.device).to(self.dt)

    def is_zero(self, a):
        return (_i16(a) == 0).all(dim=0)

    def zero_where(self, mask, a):
        return (_i16(a) * torch.logical_not(mask)).view(a.dtype)

    def is_one(self, a):
        w = _i16(a)
        return (w[0] == 1) & (w[1:] == 0).all(dim=0)

    def const_like(self, a, value: int):
        out = torch.empty(a.shape, dtype=torch.int64, device=a.device)
        for k, word in enumerate(self._const_words(value)):
            out[k].fill_(int(word))  # a kernel argument, not a copy from the host
        return out.to(self.dt)

    def repr_le(self, a, b):
        # b - a over the limbs borrows out exactly when a > b
        return normalize_limbs(b.to(torch.int64) - a.to(torch.int64))[1] == 0

    def power(self, a, e, nbits: int):
        return self.power_words(a, [e], nbits)

    def power_words(self, a, words, nbits: int):
        """a**e for e = sum_i words[i] * 2^(62 i), non-negative int64 word
        tensors, below 2^nbits: a binary ladder over the bits (0**0 = 1)."""
        return planar_power_words(a, words, nbits, self.multiply, self.square, self.one_like)


# ======================================================================
# GF(p), p > 2^32: planar base-2^16 limbs
# ======================================================================

class LimbPrimeOps(PlanarOps):
    """GF(p) for p > 2^32 on planar (L, *shape) uint16 storage: each op
    widens the limbs to int64, computes on whole limb planes, and stores
    uint16 again. Multiply: the schoolbook product of 16-bit limbs and
    Barrett reduction (HAC Algorithm 14.42, b = 2^16, mu = floor(b^(2L) / p)),
    as the JAX package. Binary ops align the operands' element axes behind
    the limb axis, so they broadcast as the elements do."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic
        self._consts = {}

    def _const(self, name: str, nd: int, device) -> torch.Tensor:
        """p's limbs zero-padded to L + 1 ("p"), or Barrett's mu ("mu"), as
        an int64 (K, 1, ..., 1) tensor on ``device``."""
        key = (name, nd, device)
        if key not in self._consts:
            limbs = self.meta.barrett_mu_limbs if name == "mu" else np.append(self.meta.prime_limbs, 0)
            self._consts[key] = torch.tensor(limbs, dtype=torch.int64, device=device).reshape((-1,) + (1,) * nd)
        return self._consts[key]

    def _wide2(self, a, b):
        a, b = align_planar(a, b)
        return a.to(torch.int64), b.to(torch.int64)

    def _sub_if_ge_p(self, r: torch.Tensor) -> torch.Tensor:
        """r - p where r >= p, over L + 1 normalized limbs."""
        d, borrow = normalize_limbs(r - self._const("p", r.ndim - 1, r.device))
        return torch.where(borrow == 0, d, r)

    def _reduce(self, X: torch.Tensor) -> torch.Tensor:
        """X (2L normalized limbs, X < b^(2L)) mod p -> L limbs (int64)."""
        L, nd = self.L, X.ndim - 1
        q3 = mul_limbs(X[L - 1 :], self._const("mu", nd, X.device))[L + 1 :]
        r2 = mul_limbs(q3, self._const("p", nd, X.device)[:L])[: L + 1]
        r, _ = normalize_limbs(X[: L + 1] - r2)  # mod b^(L+1): r in [0, 3p)
        return self._sub_if_ge_p(self._sub_if_ge_p(r))[:L]

    def multiply(self, a, b):
        A, B = self._wide2(a, b)
        return self._reduce(mul_limbs(A, B)).to(self.dt)

    def add(self, a, b):
        A, B = self._wide2(a, b)
        S = A + B
        S = torch.cat([S, torch.zeros_like(S[:1])])
        return self._sub_if_ge_p(normalize_limbs(S)[0])[: self.L].to(self.dt)

    def subtract(self, a, b):
        A, B = self._wide2(a, b)
        return self._sub_wide(A, B).to(self.dt)

    def _sub_wide(self, A, B):
        D, borrow = normalize_limbs(A - B)
        E, _ = normalize_limbs(D + self._const("p", D.ndim - 1, D.device)[: self.L])  # mod b^L
        return torch.where(borrow < 0, E, D)

    def negative(self, a):
        A = a.to(torch.int64)
        return self._sub_wide(torch.zeros_like(A), A).to(self.dt)

    def reciprocal(self, a):
        return self.power_static(a, self.p - 2)


# ======================================================================
# GF(2^m), m > 32: planar uint16 limbs of the coefficient bits
# ======================================================================

class LimbBinaryOps(PlanarOps):
    """GF(2^m), m > 32, on planar (L, *shape) uint16 limbs, L = ceil(m / 16):
    add and subtract are XORs of the limb planes, negative is the identity;
    multiply, square and the powers (``power_static``, ``power``,
    ``reciprocal`` as a^(2^m - 2), ``sqrt`` as a^(2^(m - 1))) are kernel
    K14 (``ops/_limb_binary.py``), one launch a call, its plain version on
    CPU tensors. No lookup mode, as in the JAX package."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.m = meta.degree
        self.f = meta.irreducible_poly_int

    def add(self, a, b):
        a, b = align_planar(a, b)
        return (_i16(a) ^ _i16(b)).view(torch.uint16)

    subtract = add

    def negative(self, a):
        return a

    def multiply(self, a, b):
        return gf2_limb_multiply(a, b, self.m, self.f)

    def square(self, a):
        return gf2_limb_square(a, self.m, self.f)

    def power_static(self, a, e: int):
        if e < 0:
            return self.power_static(self.reciprocal(a), -e)
        if e == 0:
            return self.one_like(a)
        # a^e = a^e' with e' = e mod (2^m - 1) in [1, 2^m - 1], for every a
        return gf2_limb_power(a, (e - 1) % (2**self.m - 1) + 1, self.m, self.f)

    def reciprocal(self, a):
        return gf2_limb_power(a, 2**self.m - 2, self.m, self.f)

    def power_words(self, a, words, nbits: int):
        return gf2_limb_power(a, list(words), self.m, self.f, nbits)

    def sqrt(self, a):
        return gf2_limb_power(a, 2 ** (self.m - 1), self.m, self.f)


# ======================================================================
# GF(p^m), p odd, p^m > 2^31: planar base-p digits
# ======================================================================

class DigitExtOps(PlanarOps):
    """GF(p^m), p odd, p^m > 2^31, on planar (m, *shape) int64 digits,
    ascending: digitwise add, subtract and negate mod p; the product is
    ``digit_product``; the reciprocal is the ladder for q - 2. Plain torch
    on every device: no TPU kernel stands behind these (the digit product's
    own kernel is queued, ``ROADMAP.md``)."""

    def __init__(self, meta: FieldMeta):
        super().__init__(meta)
        self.p = meta.characteristic
        self.m = meta.degree

    def _const_words(self, value: int):
        return self.meta.int_to_digits(value)

    def add(self, a, b):
        a, b = align_planar(a, b)
        return (a + b) % self.p

    def subtract(self, a, b):
        a, b = align_planar(a, b)
        return (a - b) % self.p

    def negative(self, a):
        return (-a) % self.p

    def multiply(self, a, b):
        return digit_product(*align_planar(a, b), self.meta)

    def reciprocal(self, a):
        return self.power_static(a, self.meta.order - 2)

    def repr_le(self, a, b):
        # lexicographic, the most significant digit first
        a, b = align_planar(a, b)
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        le = torch.ones(shape, dtype=torch.bool, device=a.device)
        decided = torch.zeros_like(le)
        for i in range(self.m - 1, -1, -1):
            differ = a[i] != b[i]
            le = torch.where(decided | ~differ, le, a[i] < b[i])
            decided = decided | differ
        return le


class GoldilocksOps(LimbPrimeOps):
    """p = 2^64 - 2^32 + 1 on planar (4, ...) uint16 storage: multiply and
    square are kernel K10 (its plain version serves CPU tensors); add,
    subtract and negative are the limb ops of ``LimbPrimeOps``."""

    def multiply(self, a, b):
        return goldilocks_multiply(a, b)

    def square(self, a):
        return goldilocks_multiply(a, a)


def kernel_mode(field) -> str:
    """The mode whose ops run a field's device work (``field``: a field
    class or array): its ufunc mode, except under 'python-calculate', which
    computes only the elementwise arithmetic on exact host ints
    (``fields/_array.py::_python_op``); reductions, linear algebra, the NTT,
    logs, LFSRs and decoders then run the default mode's ops, as in the JAX
    package."""
    mode = field._mode
    return field._meta.default_ufunc_mode if mode == "python-calculate" else mode


@functools.lru_cache(maxsize=None)
def get_ops(meta: FieldMeta, mode: str):
    """Return the ops object for (field, mode): 'jit-calculate' or
    'jit-lookup' (orders <= 2^20, not GF(2)); 'python-calculate' gets the
    default mode's object, whose device ops serve that mode's composite
    routes (``kernel_mode``)."""
    if mode == "python-calculate":
        return get_ops(meta, meta.default_ufunc_mode)
    p, m = meta.characteristic, meta.degree
    if meta.storage == STORAGE_LIMBS:
        if p == 2:
            calc = LimbBinaryOps(meta)
        else:
            calc = GoldilocksOps(meta) if p == GOLDILOCKS_P else LimbPrimeOps(meta)
    elif meta.storage == STORAGE_DIGITS:
        calc = DigitExtOps(meta)
    elif m == 1:
        calc = GF2Ops(meta) if p == 2 else PrimeOps(meta)
    elif p == 2:
        calc = BinaryExtOps(meta)
    else:
        calc = OddExtOps(meta)
    if mode == "jit-lookup":
        if mode not in meta.ufunc_modes:
            raise ValueError(f"{meta.name} does not support lookup mode.")
        return LookupOps(calc)
    if mode != "jit-calculate":
        raise ValueError(f"Argument 'mode' must be in {meta.ufunc_modes}, not {mode!r}.")
    return calc
