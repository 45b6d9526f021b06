"""Kernels K12 and K13: the shift-register scan and the long
Berlekamp-Massey scan of ``lfsr.py``, each one launch of one CTA (CUDA C++
in ``csrc/lfsr.cu``, the field arithmetic in ``csrc/field_scan.cuh``; the
source's head gives the design and what bounds each on the H100).

``lfsr_step_plain`` is the JAX package's four ``lax.scan`` tick functions
(``galois_tpu/lfsr.py:63-106``) as a torch loop over the ticks, on any field
and device; ``berlekamp_massey_long_plain`` is its ``lax.scan``
Berlekamp-Massey (``galois_tpu/lfsr.py:281-326``) step for step. Neither
reads back to the host inside its loop.

``lfsr_step`` and ``berlekamp_massey_long`` are the kernels' wrappers, for
the fields ``scan_supports`` names: int storage with GF(p), p < 2^32,
GF(2^m), m <= 32, or GF(p^m), p odd, p^m <= 2^16 (the last through the
field's EXP and LOG tables). CPU tensors take the plain version; CUDA
tensors launch the kernel (counted in ``<wrapper>.launches``) or raise.
``lfsr.py`` calls the wrapper for those fields and the plain version for
the rest (limb and digit storage, odd p^m between 2^16 and 2^31), on the
field's device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields._meta import STORAGE_INT, FieldMeta
from ._linalg import _field_reduce
from ._limbs import _where

__all__ = [
    "scan_supports",
    "lfsr_step",
    "lfsr_step_plain",
    "berlekamp_massey_long",
    "berlekamp_massey_long_plain",
]

_MODES = {("fibonacci", "forward"): 0, ("fibonacci", "backward"): 1, ("galois", "forward"): 2, ("galois", "backward"): 3}


def scan_supports(meta: FieldMeta) -> bool:
    """Whether K12 and K13 take the field (``csrc/field_scan.cuh``)."""
    if meta.storage != STORAGE_INT:
        return False
    if meta.degree == 1:
        return meta.order < 2**32
    return meta.characteristic == 2 or meta.order <= 2**16


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def _dot(ops, a, b, ax: int):
    """Field dot product of two element vectors along the element axis ax."""
    return _field_reduce(ops.add, ops.multiply(a, b), ax)


def lfsr_step_plain(ops, state, taps, steps: int, kind: str, direction: str, inv_tap=None):
    """``steps`` ticks of a Fibonacci or Galois register, forward or
    backward, on the storage tensors state and taps (the element axis after
    a leading storage axis for planar fields). ``inv_tap``: the reciprocal
    of the end tap (taps[-1] for Fibonacci, taps[0] for Galois) in storage,
    needed backward. Returns (state, outputs), the outputs stacked along the
    element axis."""
    ax = 1 if ops.meta.storage_first else 0

    def at(x, i):
        return x.narrow(ax, i, 1)

    n = state.shape[ax]
    outs = []
    for _ in range(steps):
        if (kind, direction) == ("fibonacci", "forward"):
            f = _dot(ops, state, taps, ax).unsqueeze(ax)
            outs.append(at(state, n - 1))
            state = torch.cat([f, state.narrow(ax, 0, n - 1)], dim=ax)
        elif (kind, direction) == ("fibonacci", "backward"):
            s = at(state, 0)
            if n > 1:
                shifted = state.narrow(ax, 1, n - 1)
                s = ops.subtract(s, _dot(ops, shifted, taps.narrow(ax, 0, n - 1), ax).unsqueeze(ax))
            s = ops.multiply(s, inv_tap)
            outs.append(s)
            state = torch.cat([state.narrow(ax, 1, n - 1), s], dim=ax)
        elif (kind, direction) == ("galois", "forward"):
            f = at(state, n - 1)
            fx = ops.multiply(f, taps)
            shifted = torch.cat([ops.zero_like(f), state.narrow(ax, 0, n - 1)], dim=ax)
            outs.append(f)
            state = ops.add(shifted, fx)
        else:
            f = ops.multiply(at(state, 0), inv_tap)
            fx = ops.multiply(f, taps)
            upper = ops.subtract(state.narrow(ax, 1, n - 1), fx.narrow(ax, 1, n - 1))
            outs.append(f)
            state = torch.cat([upper, f], dim=ax)
    return state, torch.cat(outs, dim=ax)


def berlekamp_massey_long_plain(ops, seq):
    """The JAX package's scan Berlekamp-Massey over one int-storage sequence
    (N,): returns c (N + 1,) in storage, ascending connection coefficients,
    and L, a 0-d int64 tensor. Capacity K = N + 1 holds every intermediate."""
    N = seq.shape[0]
    K = N + 1
    dev, dt = seq.device, seq.dtype
    padded = torch.cat([torch.zeros(K - 1, dtype=dt, device=dev), seq])
    idx = torch.arange(K, device=dev)
    one = ops.one_like(torch.zeros((), dtype=dt, device=dev))
    c = torch.zeros(K, dtype=dt, device=dev)
    c[0].fill_(1)
    b = c.clone()
    L = torch.zeros((), dtype=torch.int64, device=dev)
    m = torch.ones((), dtype=torch.int64, device=dev)
    bcoef = one
    for t in range(N):
        win = padded[t : t + K]
        d = _dot(ops, c, win.flip(0), 0)
        coef = ops.multiply(d, ops.reciprocal(bcoef))
        shifted = _where(idx >= m, b[(idx - m) % K], torch.zeros_like(b))
        c_new = ops.subtract(c, ops.multiply(coef.expand(K), shifted))
        d_zero = ops.is_zero(d)
        relen = ~d_zero & (2 * L <= t)
        c, b = _where(d_zero, c, c_new), _where(relen, c, b)
        bcoef = _where(relen, d, bcoef)
        L = torch.where(relen, t + 1 - L, L)
        m = torch.where(relen, 1, m + 1)
    return c, L


# ----------------------------------------------------------------------
# The kernels' wrappers
# ----------------------------------------------------------------------

class _Field(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int),
        ("p", ctypes.c_uint32),
        ("m", ctypes.c_int),
        ("f", ctypes.c_uint32),
        ("q1", ctypes.c_uint32),
        ("exp", ctypes.c_void_p),
        ("log", ctypes.c_void_p),
    ]


def _field(ops, device) -> _Field:
    """The kernel's description of the ops' field; the EXP and LOG tables
    (int32, from the field's one table cache on ``device``) for odd p^m."""
    meta = ops.meta
    p, m = meta.characteristic, meta.degree
    if m == 1:
        return _Field(0, p, 1, 0, meta.order - 1, None, None)
    if p == 2:
        return _Field(1, 2, m, meta.irreducible_poly_int ^ (1 << m), meta.order - 1, None, None)
    from ._lookup import field_tables

    exp_t, log_t = field_tables(meta, device)[:2]
    return _Field(2, p, m, 0, meta.order - 1, exp_t.data_ptr(), log_t.data_ptr())


@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("lfsr")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lfsr_step_launch.argtypes = [vp, vp, vp, vp, i64, i32, i32, ctypes.c_uint, vp, i32, _Field, vp]
    lib.lfsr_scratch_needed.argtypes = [i32]
    lib.bm_long_launch.argtypes = [vp, i64, vp, vp, vp, i32, _Field, vp]
    lib.bm_long_scratch_needed.argtypes = [i64]
    for fn in (lib.lfsr_step_launch, lib.lfsr_scratch_needed, lib.bm_long_launch, lib.bm_long_scratch_needed):
        fn.restype = i32
    return lib


def _check(name: str, ops, *xs) -> None:
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}; need one CUDA device.")
    if not scan_supports(ops.meta):
        raise ValueError(f"{name}: the kernel does not take {ops.meta.name} ({ops.meta.storage} storage).")
    if any(x.dtype != ops.meta.torch_dtype for x in xs):
        raise TypeError(f"{name}: needs {ops.meta.torch_dtype} storage, got {[x.dtype for x in xs]}.")


def lfsr_step(ops, state, taps, steps: int, kind: str, direction: str, inv_tap: int = 0):
    """K12: ``lfsr_step_plain``'s (state, outputs) for a field inside
    ``scan_supports``; ``inv_tap`` is the reciprocal of the end tap as a
    Python int (backward only). CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``lfsr_step.launches``) or raise.
    The state lives in registers up to 1024 taps, in shared memory up to
    about 19,000, in a global scratch above."""
    if state.device.type == "cpu" and taps.device.type == "cpu":
        inv = torch.full((1,), inv_tap, dtype=state.dtype) if direction == "backward" else None
        return lfsr_step_plain(ops, state, taps, steps, kind, direction, inv)
    _check("lfsr_step", ops, state, taps)
    k = state.shape[0]
    if state.shape != taps.shape or state.ndim != 1 or not 1 <= k < 2**31:
        raise ValueError(f"lfsr_step: state {tuple(state.shape)} and taps {tuple(taps.shape)}; need (k,).")
    state, taps = state.contiguous(), taps.contiguous()
    new_state = torch.empty_like(state)
    out = torch.empty(steps, dtype=state.dtype, device=state.device)
    if steps:
        lib = _lib()
        scratch = torch.empty(3 * k, dtype=torch.int32, device=state.device) if lib.lfsr_scratch_needed(k) else None
        with torch.cuda.device(state.device):
            rc = lib.lfsr_step_launch(
                state.data_ptr(), taps.data_ptr(), new_state.data_ptr(), out.data_ptr(), steps, k,
                _MODES[(kind, direction)], inv_tap, None if scratch is None else scratch.data_ptr(),
                int(state.dtype == torch.uint8), _field(ops, state.device),
                ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"lfsr_step: kernel launch failed with CUDA error {rc}.")
        lfsr_step.launches += 1
    else:
        new_state.copy_(state)
    return new_state, out


def berlekamp_massey_long(ops, seq):
    """K13: ``berlekamp_massey_long_plain``'s (c, L) for one sequence (N,)
    of a field inside ``scan_supports``. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in
    ``berlekamp_massey_long.launches``) or raise. c and b live in shared
    memory up to N of about 18,900, in a global scratch above."""
    if seq.device.type == "cpu":
        return berlekamp_massey_long_plain(ops, seq)
    _check("berlekamp_massey_long", ops, seq)
    if seq.ndim != 1 or seq.shape[0] < 1:
        raise ValueError(f"berlekamp_massey_long: needs one sequence (N,), got {tuple(seq.shape)}.")
    seq = seq.contiguous()
    N = seq.shape[0]
    c = torch.empty(N + 1, dtype=seq.dtype, device=seq.device)
    L = torch.empty((), dtype=torch.int64, device=seq.device)
    lib = _lib()
    scratch = torch.empty(3 * (N + 1), dtype=torch.int32, device=seq.device) if lib.bm_long_scratch_needed(N) else None
    with torch.cuda.device(seq.device):
        rc = lib.bm_long_launch(
            seq.data_ptr(), N, c.data_ptr(), L.data_ptr(), None if scratch is None else scratch.data_ptr(),
            int(seq.dtype == torch.uint8), _field(ops, seq.device),
            ctypes.c_void_p(torch.cuda.current_stream(seq.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"berlekamp_massey_long: kernel launch failed with CUDA error {rc}.")
    berlekamp_massey_long.launches += 1
    return c, L


lfsr_step.launches = 0
berlekamp_massey_long.launches = 0
