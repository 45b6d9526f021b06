"""Kernels K3-K6: the EXP/LOG table gathers of lookup mode.

Wrappers and plain versions for ``csrc/lookup.cu`` (CUDA C++, built by
``_build.py`` for sm_90a and bound with ctypes). They replace
``lookup_multiply_pallas`` (K3), ``lookup_divide_pallas`` (K4),
``lookup_reciprocal_pallas`` (K5) and ``lookup_log_pallas`` (K6) of
``galois_tpu/ops/_pallas/_elementwise.py``; the source file's head says what
bounds them on the H100 and how their design differs from the TPU's.

Tables are the field's EXP (int32, length 2(q-1)) and LOG (int32, length q)
on the data's device; elements are storage tensors (uint8 for q <= 2^8,
else int64) holding values in [0, q). K3-K6 read the tables in the form
that ``lookup_placement`` picks for ``(q, dtype)`` and ``pack_tables``
builds (``field_tables`` keeps one per field and device). Each wrapper
serves CPU tensors with its plain version and launches its kernel for CUDA
tensors, counting the launch in ``<wrapper>.launches``; it raises on
anything else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields._meta import FieldMeta
from ..fields._tables import build_exp_log

__all__ = [
    "lookup_multiply",
    "lookup_divide",
    "lookup_reciprocal",
    "lookup_log",
    "lookup_multiply_plain",
    "lookup_divide_plain",
    "lookup_reciprocal_plain",
    "lookup_log_plain",
    "lookup_placement",
    "pack_tables",
    "field_tables",
    "gf2m_packed_tables",
]

_MUL, _DIV, _RECIP, _LOG = 0, 1, 2, 3  # op codes of the launchers

# The largest order of the 'shared' placement, where K3 and K4 keep LOG and
# the reduced EXP in shared memory as uint16 (64 KB at 2^14).
SMEM_MAX_ORDER = 2**14

# Table placements, in the order of the launchers' codes.
PLACEMENTS = ("bytes", "shared", "log-shared", "global")


def lookup_placement(q: int, dtype: torch.dtype) -> str:
    """Where K3-K6 read the tables of GF(q) for storage ``dtype``: 'bytes'
    (uint8: the byte rows of ``pack_tables`` in shared memory, one copy per
    bank), 'shared' (int64, q <= 2^14: K3/K4 keep uint16 LOG and reduced
    EXP in shared memory), 'log-shared' (int64, q <= 2^16: K3/K4 keep uint16
    LOG in shared memory and gather the reduced EXP from global memory) or
    'global' (int64, q <= 2^20: the int32 tables in global memory). On both
    uint16 placements K5 and K6 stage the one segment they read, INV or
    LOG."""
    if dtype == torch.uint8 and 2 < q <= 2**8:
        return "bytes"
    if dtype == torch.int64 and 2 < q <= 2**20:
        return "shared" if q <= SMEM_MAX_ORDER else "log-shared" if q <= 2**16 else "global"
    raise ValueError(f"order {q} has no lookup tables for {dtype} storage.")


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def packed_length(q: int, place: str) -> int:
    """Entries of ``pack_tables``' table for a placement other than
    'global': 2(q-1) int32 rows for 'bytes', q8 + e8 + q8 int16 entries
    (LOG, reduced EXP, INV) for the uint16 placements."""
    return 2 * (q - 1) if place == "bytes" else 2 * _round8(q) + _round8(q - 1)


def pack_tables(exp_t: torch.Tensor, log_t: torch.Tensor, q: int, dtype: torch.dtype):
    """The table K3-K6 read for ``lookup_placement(q, dtype)``, built on the
    tables' device from the int32 EXP (doubled, so EXP[i + q - 1] = EXP[i])
    and LOG, so that the tables a field holds decide every entry. INV[r] is
    EXP[(q-1) - LOG[r]] for every r < q, the reciprocal for r > 0 and
    EXP[q-1] = 1 for r = 0, as K5's plain version gives.

    - 'bytes': int32 words of 2(q-1) rows, byte 0 LOG[r] (r < q), byte 1
      EXP[r], byte 2 (q-1) - LOG[r] (r < q), byte 3 INV[r] (r < q);
    - 'shared' and 'log-shared': int16 holding uint16 bits, LOG at [0, q),
      the reduced EXP (its first q - 1 entries) at [q8, q8 + q - 1) and INV
      at [q8 + e8, q8 + e8 + q), q8 and e8 being q and q - 1 rounded up to
      8 entries (16 bytes), and so the length (``packed_length``);
    - 'global': None (the kernels read exp_t and log_t)."""
    place = lookup_placement(q, dtype)
    if place == "global":
        return None
    log_t, exp_t = log_t.to(torch.int32), exp_t.to(torch.int32)
    inv = exp_t[((q - 1) - log_t).long()]
    if place == "bytes":
        rows = 2 * (q - 1)
        log_r = torch.zeros(rows, dtype=torch.int32, device=log_t.device)
        nlog_r, inv_r = torch.zeros_like(log_r), torch.zeros_like(log_r)
        log_r[:q] = log_t
        nlog_r[:q] = (q - 1) - log_t
        inv_r[:q] = inv
        return log_r | (exp_t << 8) | (nlog_r << 16) | (inv_r << 24)
    q8, e8 = _round8(q), _round8(q - 1)
    packed = torch.zeros(packed_length(q, place), dtype=torch.int32, device=log_t.device)
    packed[:q] = log_t
    packed[q8 : q8 + q - 1] = exp_t[: q - 1]
    packed[q8 + e8 : q8 + e8 + q] = inv
    return torch.where(packed >= 2**15, packed - 2**16, packed).to(torch.int16)


@functools.lru_cache(maxsize=None)
def field_tables(meta: FieldMeta, device: torch.device):
    """(EXP, LOG, packed) of the field ``meta`` on ``device``: its
    ``build_exp_log`` tables as int32 and ``pack_tables``' table for its
    storage, built once per field and device and shared by every kernel
    that reads them."""
    exp_t, log_t = (torch.from_numpy(t.astype(np.int32)).to(device) for t in build_exp_log(meta))
    return exp_t, log_t, pack_tables(exp_t, log_t, meta.order, meta.torch_dtype)


@functools.lru_cache(maxsize=None)
def gf2m_packed_tables(m: int, f: int, device: torch.device):
    """``pack_tables``' table of GF(2)[x]/f, 2 <= m <= 16, for its storage
    (uint8 for m <= 8, int64 above) on ``device``: ``field_tables``' for the
    field ``GF(2**m, irreducible_poly=f)``, so the one tensor that K8, K8-A
    and K8-B read, that ``BinaryExtOps.packed_tables`` serves and that K3-K6
    read for that field in lookup mode. Every primitive element gives the
    same products, reciprocals and powers. Raises ValueError where f is not
    irreducible of degree m."""
    from ..fields import GF  # the field factory imports this module

    return field_tables(GF(2**m, irreducible_poly=f)._meta, torch.device(device))[2]


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def lookup_multiply_plain(a, b, exp_t, log_t, q: int) -> torch.Tensor:
    """EXP[LOG[a] + LOG[b]], or 0 where a or b is 0."""
    a, b = torch.broadcast_tensors(a, b)
    r = exp_t[(log_t[a.long()] + log_t[b.long()]).long()]
    return torch.where((a == 0) | (b == 0), 0, r).to(a.dtype)


def lookup_divide_plain(a, b, exp_t, log_t, q: int) -> torch.Tensor:
    """EXP[LOG[a] + (q-1) - LOG[b]], or 0 where a is 0 (b != 0 is the
    caller's check)."""
    a, b = torch.broadcast_tensors(a, b)
    r = exp_t[(log_t[a.long()] + (q - 1) - log_t[b.long()]).long()]
    return torch.where(a == 0, 0, r).to(a.dtype)


def lookup_reciprocal_plain(a, exp_t, log_t, q: int) -> torch.Tensor:
    """EXP[(q-1) - LOG[a]] (a != 0 is the caller's check)."""
    return exp_t[((q - 1) - log_t[a.long()]).long()].to(a.dtype)


def lookup_log_plain(a, log_t, q: int) -> torch.Tensor:
    """LOG[a] as int64."""
    return log_t[a.long()].to(torch.int64)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("lookup")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lookup_binary_launch.argtypes = [i32, i32, vp, i32, vp, i32, vp, vp, vp, vp, i32, i64, vp]
    lib.lookup_unary_launch.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32, i64, vp]
    lib.lookup_binary_launch.restype = lib.lookup_unary_launch.restype = i32
    return lib


def _check(fn: str, q: int, operands, exp_t, log_t) -> None:
    a = operands[0]
    if a.device.type != "cuda" or any(x.device != a.device for x in operands):
        raise ValueError(f"{fn}: operands on {[str(x.device) for x in operands]}; need one CUDA device.")
    if a.dtype not in (torch.uint8, torch.int64) or any(x.dtype != a.dtype for x in operands):
        raise TypeError(f"{fn}: storage dtypes {[x.dtype for x in operands]}; need uint8 or int64.")
    if not 2 < q <= 2**20 or (a.dtype == torch.uint8 and q > 2**8):
        raise ValueError(f"{fn}: order {q} has no lookup tables for {a.dtype} storage.")
    for t, length in ((exp_t, 2 * (q - 1)), (log_t, q)):
        if t is not None and (t.device != a.device or t.dtype != torch.int32 or t.shape != (length,)):
            raise ValueError(f"{fn}: tables must be int32 of lengths 2(q-1) and q on {a.device}.")


def _stream(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)


def _placed(fn: str, q: int, a, exp_t, log_t, packed):
    """(placement code, packed table) for the operand ``a``: ``packed`` is
    checked to be ``pack_tables``' for this field, storage and device, or
    built here when it is None. K6 has no EXP to hand (``exp_t`` None) and
    reads only LOG, so its table is built with zeros for EXP."""
    place = lookup_placement(q, a.dtype)
    if place == "global":
        return PLACEMENTS.index(place), None
    if packed is None:
        if exp_t is None:
            exp_t = torch.zeros(2 * (q - 1), dtype=torch.int32, device=log_t.device)
        packed = pack_tables(exp_t, log_t, q, a.dtype)
    want = (torch.int32 if place == "bytes" else torch.int16, packed_length(q, place))
    if (packed.dtype, packed.numel()) != want or packed.device != a.device or packed.data_ptr() % 16:
        raise ValueError(f"{fn}: the packed table is not pack_tables' for GF({q}) {a.dtype} on {a.device}.")
    return PLACEMENTS.index(place), packed


def _launch_binary(fn: str, op: int, q: int, a, b, exp_t, log_t, packed) -> torch.Tensor:
    """K3 or K4 on CUDA operands: check them, allocate the output and
    launch one kernel (none for an empty output). An operand of one element
    reaches the kernel by stride 0; other broadcasts are materialized."""
    _check(fn, q, (a, b), exp_t, log_t)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if not out.numel():
        return out
    place, packed = _placed(fn, q, a, exp_t, log_t, packed)
    ones = [x.numel() == 1 for x in (a, b)]
    a, b = (x if one else x.expand(shape).contiguous() for x, one in zip((a, b), ones))
    exp_t, log_t = exp_t.contiguous(), log_t.contiguous()
    with torch.cuda.device(a.device):
        rc = _lib().lookup_binary_launch(
            op, place, a.data_ptr(), ones[0], b.data_ptr(), ones[1], out.data_ptr(),
            None if packed is None else packed.data_ptr(), exp_t.data_ptr(), log_t.data_ptr(), q, out.numel(),
            _stream(a),
        )
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}.")
    return out


def _launch_unary(fn: str, op: int, q: int, a, exp_t, log_t, packed, out_dtype) -> torch.Tensor:
    """K5 or K6 on a CUDA operand (``exp_t`` is None for K6), read by the
    same placement as K3 and K4; a view off 16-byte alignment is streamed
    as it lies."""
    _check(fn, q, (a,), exp_t, log_t)
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    if not out.numel():
        return out
    place, packed = _placed(fn, q, a, exp_t, log_t, packed)
    a, exp_t, log_t = (None if t is None else t.contiguous() for t in (a, exp_t, log_t))
    with torch.cuda.device(a.device):
        rc = _lib().lookup_unary_launch(
            op, place, a.data_ptr(), out.data_ptr(), None if packed is None else packed.data_ptr(),
            None if exp_t is None else exp_t.data_ptr(), log_t.data_ptr(), q, a.numel(), _stream(a),
        )
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}.")
    return out


def lookup_multiply(a, b, exp_t, log_t, q: int, packed=None) -> torch.Tensor:
    """K3: GF(q) product of two storage tensors (broadcast) by table gathers.
    ``packed`` is ``pack_tables(exp_t, log_t, q, a.dtype)``, built here when
    not given."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lookup_multiply_plain(a, b, exp_t, log_t, q)
    out = _launch_binary("lookup_multiply", _MUL, q, a, b, exp_t, log_t, packed)
    lookup_multiply.launches += bool(out.numel())
    return out


def lookup_divide(a, b, exp_t, log_t, q: int, packed=None) -> torch.Tensor:
    """K4: a / b by table gathers (broadcast); the caller checks b != 0.
    ``packed`` as for ``lookup_multiply``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lookup_divide_plain(a, b, exp_t, log_t, q)
    out = _launch_binary("lookup_divide", _DIV, q, a, b, exp_t, log_t, packed)
    lookup_divide.launches += bool(out.numel())
    return out


def lookup_reciprocal(a, exp_t, log_t, q: int, packed=None) -> torch.Tensor:
    """K5: 1 / a by one table read per element; the caller checks a != 0.
    ``packed`` as for ``lookup_multiply``."""
    if a.device.type == "cpu":
        return lookup_reciprocal_plain(a, exp_t, log_t, q)
    out = _launch_unary("lookup_reciprocal", _RECIP, q, a, exp_t, log_t, packed, a.dtype)
    lookup_reciprocal.launches += bool(a.numel())
    return out


def lookup_log(a, log_t, q: int, packed=None) -> torch.Tensor:
    """K6: the discrete log base the primitive element, LOG[a], as int64.
    ``packed`` as for ``lookup_multiply``."""
    if a.device.type == "cpu":
        return lookup_log_plain(a, log_t, q)
    out = _launch_unary("lookup_log", _LOG, q, a, None, log_t, packed, torch.int64)
    lookup_log.launches += bool(a.numel())
    return out


lookup_multiply.launches = 0
lookup_divide.launches = 0
lookup_reciprocal.launches = 0
lookup_log.launches = 0
