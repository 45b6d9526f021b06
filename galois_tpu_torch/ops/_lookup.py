"""Kernels K3-K6: the EXP/LOG table gathers of lookup mode.

Wrappers and plain versions for ``csrc/lookup.cu`` (CUDA C++, built by
``_build.py`` for sm_90a and bound with ctypes). They replace
``lookup_multiply_pallas`` (K3), ``lookup_divide_pallas`` (K4),
``lookup_reciprocal_pallas`` (K5) and ``lookup_log_pallas`` (K6) of
``galois_tpu/ops/_pallas/_elementwise.py``; the source file's head says what
bounds them on the H100 and how their design differs from the TPU's.

Tables are the field's EXP (int32, length 2(q-1)) and LOG (int32, length q)
on the data's device; elements are storage tensors (uint8 for q <= 2^8,
else int64) holding values in [0, q). Each wrapper serves CPU tensors with
its plain version and launches its kernel for CUDA tensors, counting the
launch in ``<wrapper>.launches``; it raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "lookup_multiply",
    "lookup_divide",
    "lookup_reciprocal",
    "lookup_log",
    "lookup_multiply_plain",
    "lookup_divide_plain",
    "lookup_reciprocal_plain",
    "lookup_log_plain",
]

_MUL, _DIV, _RECIP, _LOG = 0, 1, 2, 3  # op codes of lookup_launch

# Orders up to this stage their tables in shared memory as uint16 (6q bytes,
# 96 KB at 2^14, so two blocks share an SM); larger ones gather from global
# memory, out of L2.
SMEM_MAX_ORDER = 2**14


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
    lib.lookup_launch.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, i32, i64, vp]
    lib.lookup_launch.restype = i32
    return lib


def _launch(fn: str, op: int, q: int, a, b, exp_t, log_t, out_dtype) -> torch.Tensor:
    """Check the operands, allocate the output and launch one kernel (none
    for an empty tensor). ``b`` is None for K5 and K6, ``exp_t`` for K6."""
    operands = [x for x in (a, b) if x is not None]
    if a.device.type != "cuda" or any(x.device != a.device for x in operands):
        raise ValueError(f"{fn}: operands on {[str(x.device) for x in operands]}; need one CUDA device.")
    if a.dtype not in (torch.uint8, torch.int64) or any(x.dtype != a.dtype for x in operands):
        raise TypeError(f"{fn}: storage dtypes {[x.dtype for x in operands]}; need uint8 or int64.")
    if not 2 < q <= 2**20 or (a.dtype == torch.uint8 and q > 2**8):
        raise ValueError(f"{fn}: order {q} has no lookup tables for {a.dtype} storage.")
    for t, length in ((exp_t, 2 * (q - 1)), (log_t, q)):
        if t is not None and (t.device != a.device or t.dtype != torch.int32 or t.shape != (length,)):
            raise ValueError(f"{fn}: tables must be int32 of lengths 2(q-1) and q on {a.device}.")
    a, b, exp_t, log_t = (None if t is None else t.contiguous() for t in (a, b, exp_t, log_t))
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    if a.numel():
        with torch.cuda.device(a.device):
            rc = _lib().lookup_launch(
                op, a.element_size(), int(q <= SMEM_MAX_ORDER), a.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(),
                None if exp_t is None else exp_t.data_ptr(), log_t.data_ptr(), q, a.numel(),
                ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}.")
    return out


def lookup_multiply(a, b, exp_t, log_t, q: int) -> torch.Tensor:
    """K3: GF(q) product of two storage tensors (broadcast) by table gathers."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lookup_multiply_plain(a, b, exp_t, log_t, q)
    out = _launch("lookup_multiply", _MUL, q, a, b, exp_t, log_t, a.dtype)
    lookup_multiply.launches += bool(a.numel())
    return out


def lookup_divide(a, b, exp_t, log_t, q: int) -> torch.Tensor:
    """K4: a / b by table gathers; the caller checks b != 0."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lookup_divide_plain(a, b, exp_t, log_t, q)
    out = _launch("lookup_divide", _DIV, q, a, b, exp_t, log_t, a.dtype)
    lookup_divide.launches += bool(a.numel())
    return out


def lookup_reciprocal(a, exp_t, log_t, q: int) -> torch.Tensor:
    """K5: 1 / a by table gathers; the caller checks a != 0."""
    if a.device.type == "cpu":
        return lookup_reciprocal_plain(a, exp_t, log_t, q)
    out = _launch("lookup_reciprocal", _RECIP, q, a, None, exp_t, log_t, a.dtype)
    lookup_reciprocal.launches += bool(a.numel())
    return out


def lookup_log(a, log_t, q: int) -> torch.Tensor:
    """K6: the discrete log base the primitive element, LOG[a], as int64."""
    if a.device.type == "cpu":
        return lookup_log_plain(a, log_t, q)
    out = _launch("lookup_log", _LOG, q, a, None, None, log_t, torch.int64)
    lookup_log.launches += bool(a.numel())
    return out


lookup_multiply.launches = 0
lookup_divide.launches = 0
lookup_reciprocal.launches = 0
lookup_log.launches = 0
