"""Kernels K12 and K13: the shift-register scan and the long
Berlekamp-Massey scan of ``lfsr.py``, each one launch of one CTA (CUDA C++
in ``csrc/lfsr.cu``, the field arithmetic in ``csrc/field_scan.cuh``; the
source's head gives the design and what bounds each on the H100). Up to
1024 taps K12 takes 32 ticks at a time as two fixed matrix products of the
taps and the mode (``block_matrices`` builds them by the plain tick loop on
the identity; the wrapper by one launch of the kernel itself on the k basis
states, kept by the register between calls), and the rest of the ticks one
by one. K13 takes GF(2) 32 steps a block by lookahead on packed words, and
the other fields' steps on one warp while c is short (runs of zero
discrepancies 32 at a time), on the whole CTA after.

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
    "BLOCK_TICKS",
    "BM_S",
    "BUILD_TICKS",
    "block_matrices",
    "block_layout",
    "block_inputs",
    "scan_supports",
    "lfsr_step",
    "lfsr_step_plain",
    "berlekamp_massey_long",
    "berlekamp_massey_long_plain",
]

_MODES = {("fibonacci", "forward"): 0, ("fibonacci", "backward"): 1, ("galois", "forward"): 2, ("galois", "backward"): 3}
BLOCK_TICKS = 32  # K12's ticks a block (csrc/lfsr.cu BLK)
# A call without the block form's matrices builds them from this many ticks: the build (one launch
# of B ticks on k registers and about 35 small torch passes: about 0.5 ms, mostly host time, beside
# an H100) then costs less than the ticks it saves (0.4-0.55 us each tick by tick there)
BUILD_TICKS = 32 * BLOCK_TICKS
_BLOCK_MAX_TAPS = 1024  # the block form's largest register; above, tick by tick
BM_MAX_N = 2**28  # K13's longest sequence (csrc/lfsr.cu)
BM_S = 32  # K13's steps a block over GF(2), and its batch of zero discrepancies elsewhere (csrc/lfsr.cu)
# K13's shared-memory budget for its buffers and the staged sequence, above which they go to a global
# scratch: None for the kernel's own (csrc/lfsr.cu BM_SMEM, 219 KB); a smaller value (0) forces the
# global form
BM_SMEM_BYTES = None
# field_scan.cuh's kinds
_GF2, _PRIME, _BINARY, _BINTAB, _ODDTAB = range(5)


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


def block_matrices(ops, taps, kind: str, direction: str, inv_tap=None, B: int = BLOCK_TICKS):
    """K12's block form for B ticks of the register with these taps (k,),
    in storage: (D, G, P, Y) from B ticks of ``lfsr_step_plain`` on the
    identity (column c the basis state e_c), so that B ticks of any state s
    are the outputs Y s and the state P s. D (B, k) is what the kernel's
    dots compute: the outputs Y for Galois and Fibonacci backward, and for
    Fibonacci forward the feedback values of the B ticks (tick t's is output
    t + k, or row B - 1 - t of the new state). G (k, min(B, k)), Galois
    only (None for Fibonacci), is the columns of P that the shift of the
    state by B does not cover: those of the B elements that leave it (the
    last min(B, k) forward, the first backward). ``inv_tap``: as
    ``lfsr_step_plain``'s."""
    k = taps.shape[0]
    eye = torch.eye(k, dtype=torch.int64, device=taps.device).to(taps.dtype)
    P, Y = lfsr_step_plain(ops, eye, taps.reshape(k, 1), B, kind, direction, inv_tap)
    return (*_block_form(P, Y, kind, direction), P, Y)


def _block_form(P, Y, kind: str, direction: str):
    """``block_matrices``' (D, G) from P (k, k) and Y (B, k)."""
    k, B = P.shape[0], Y.shape[0]
    if kind == "galois":
        cw = min(B, k)
        col0 = k - cw if direction == "forward" else 0
        return Y, P[:, col0 : col0 + cw]
    if direction == "forward":  # rows t < B - k: Y[t + k]; the rest P[B - 1 - t]
        return torch.cat([Y[k:], P[: min(B, k)].flip(0)]), None
    return Y, None


def block_layout(M, threads: int, rows_first: bool) -> torch.Tensor:
    """The kernel's layout of a block matrix for a CTA of ``threads``
    threads, (BLOCK_TICKS, threads) int64: thread tid's r-th entry at
    [r, tid]. D (rows_first): thread (w, l) = (tid // 32, tid % 32) takes row
    l's entries w, w + nw, w + 2 nw, ... (nw = threads / 32); G: thread i
    takes row i. Entries past the matrix are 0."""
    r = torch.arange(BLOCK_TICKS, device=M.device).unsqueeze(1)
    tid = torch.arange(threads, device=M.device).unsqueeze(0)
    if rows_first:
        row, col = (tid % 32).expand(BLOCK_TICKS, -1), tid // 32 + (threads // 32) * r
    else:
        row, col = tid.expand(BLOCK_TICKS, -1), r.expand(-1, threads)
    ok = (row < M.shape[0]) & (col < M.shape[1])
    vals = M.to(torch.int64)[row.clamp(max=M.shape[0] - 1), col.clamp(max=M.shape[1] - 1)]
    return torch.where(ok, vals, torch.zeros_like(vals))


# ----------------------------------------------------------------------
# The kernels' wrappers
# ----------------------------------------------------------------------

class _Field(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_uint32),
        ("m", ctypes.c_int),
        ("f", ctypes.c_uint32),
        ("q1", ctypes.c_uint32),
        ("mu", ctypes.c_ulonglong),
        ("pinv", ctypes.c_uint32),
        ("sent", ctypes.c_uint32),
        ("exp", ctypes.c_void_p),
        ("log", ctypes.c_void_p),
    ]


def _kind(meta) -> int:
    """``field_scan.cuh``'s kind of a field ``scan_supports`` takes."""
    p, m = meta.characteristic, meta.degree
    if m == 1:
        return _GF2 if p == 2 else _PRIME
    if p == 2:
        return _BINTAB if m <= 16 else _BINARY
    return _ODDTAB


@functools.lru_cache(maxsize=None)
def _scan_tables(meta, device: str):
    """The table kinds' (EXP extended, LOG) int32 tensors on ``device``: the
    field's one EXP (2 (q - 1) entries) followed by 2 (q - 1) + 1 zeros, so
    that EXP[LOG a + LOG b] is 0 where 0's LOG is taken as 2 (q - 1)."""
    from ._lookup import field_tables

    exp_t, log_t = field_tables(meta, torch.device(device))[:2]
    return torch.cat([exp_t, torch.zeros(exp_t.numel() + 1, dtype=exp_t.dtype, device=exp_t.device)]), log_t


def _field(ops, device):
    """(kind, the kernel's description of the ops' field); for the table
    kinds, the EXP (extended with zeros) and LOG tables on ``device``."""
    meta = ops.meta
    p, m, kind = meta.characteristic, meta.degree, _kind(meta)
    q1 = meta.order - 1
    F = _Field(p, m, 0, q1, 2**64 // p if kind == _PRIME else 0, -(-(2**32) // p) if kind == _ODDTAB else 0)
    if kind == _BINARY:
        F.f = meta.irreducible_poly_int ^ (1 << m)
    if kind in (_BINTAB, _ODDTAB):
        exp_t, log_t = _scan_tables(meta, str(device))
        F.sent, F.exp, F.log = 2 * q1, exp_t.data_ptr(), log_t.data_ptr()
    return kind, F


def _blocks(ops, taps, kind: str, direction: str, inv_tap: int, F):
    """The block form's D and G for these taps, laid out and prepared for
    the kernel (int32): P and Y come from one launch of the kernel itself,
    B ticks of k registers with these taps, register c from the basis state
    e_c (``block_matrices`` builds the same by the plain loop), then a few
    torch passes; nothing is read back."""
    k, dev = taps.shape[0], taps.device
    eye = torch.eye(k, dtype=torch.int64, device=dev).to(taps.dtype)
    Pt = torch.empty((k, k), dtype=taps.dtype, device=dev)  # row c: the state after B ticks from e_c
    Yt = torch.empty((k, BLOCK_TICKS), dtype=taps.dtype, device=dev)  # row c: its B outputs
    _launch(eye, taps, Pt, Yt, BLOCK_TICKS, kind, direction, inv_tap, F, None, None, 0, k)
    return block_inputs(ops, *_block_form(Pt.T, Yt.T, kind, direction), k)


def block_inputs(ops, D, G, k: int):
    """D and G (None for Fibonacci) as the kernel reads them: the entries,
    or for the table kinds their LOG (2 (q - 1) for 0), in ``block_layout``'s
    layout for the CTA of k taps, as int32."""
    threads = -(-k // 32) * 32

    def prepared(M):
        M = M.to(torch.int64)
        if _kind(ops.meta) in (_BINTAB, _ODDTAB):
            log_t = _scan_tables(ops.meta, str(M.device))[1].to(torch.int64)
            M = torch.where(M == 0, 2 * (ops.meta.order - 1), log_t[M])
        return M

    lay = [block_layout(prepared(D), threads, True)]
    lay.append(None if G is None else block_layout(prepared(G), threads, False))
    return [None if x is None else torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous() for x in lay]


@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("lfsr")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.lfsr_step_launch.argtypes = [
        vp, vp, vp, vp, i64, i32, i32, ctypes.c_uint, vp, i32, i32, _Field, vp, vp, i64, i32, vp,
    ]
    lib.lfsr_scratch_needed.argtypes = [i32]
    lib.bm_long_launch.argtypes = [vp, i32, vp, vp, vp, i32, i32, _Field, i64, vp]
    lib.bm_long_scratch_words.argtypes = [i32, i32, ctypes.c_uint, i64]
    for fn in (lib.lfsr_step_launch, lib.lfsr_scratch_needed, lib.bm_long_launch):
        fn.restype = i32
    lib.bm_long_scratch_words.restype = i64
    return lib


def _check(name: str, ops, *xs) -> None:
    dev = xs[0].device
    if dev.type != "cuda" or any(x.device != dev for x in xs):
        raise ValueError(f"{name}: operands on {[str(x.device) for x in xs]}; need one CUDA device.")
    if not scan_supports(ops.meta):
        raise ValueError(f"{name}: the kernel does not take {ops.meta.name} ({ops.meta.storage} storage).")
    if any(x.dtype != ops.meta.torch_dtype for x in xs):
        raise TypeError(f"{name}: needs {ops.meta.torch_dtype} storage, got {[x.dtype for x in xs]}.")


def _launch(state, taps, new_state, out, steps, kind, direction, inv_tap, F, D, G, nblk, nregs):
    """One launch of K12 on ``nregs`` registers (counted in ``lfsr_step.launches``)."""
    lib = _lib()
    k = taps.shape[0]
    scratch = torch.empty(3 * k, dtype=torch.int32, device=state.device) if lib.lfsr_scratch_needed(k) else None
    with torch.cuda.device(state.device):
        rc = lib.lfsr_step_launch(
            state.data_ptr(), taps.data_ptr(), new_state.data_ptr(), out.data_ptr(), steps, k,
            _MODES[(kind, direction)], inv_tap, None if scratch is None else scratch.data_ptr(),
            int(state.dtype == torch.uint8), F[0], F[1], None if D is None else D.data_ptr(),
            None if G is None else G.data_ptr(), nblk, nregs,
            ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"lfsr_step: kernel launch failed with CUDA error {rc}.")
    lfsr_step.launches += 1


def lfsr_step(ops, state, taps, steps: int, kind: str, direction: str, inv_tap: int = 0, blocks=None):
    """K12: ``lfsr_step_plain``'s (state, outputs) for a field inside
    ``scan_supports``; ``inv_tap`` is the reciprocal of the end tap as a
    Python int (backward only). CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``lfsr_step.launches``) or raise.
    Up to 1024 taps and from 2 BLOCK_TICKS ticks the kernel takes blocks of
    BLOCK_TICKS ticks, the rest tick by tick, when it has the block form's
    matrices: ``blocks`` is a dict that keeps them between calls for one
    register (its taps, field and mode fixed; an LFSR keeps one), keyed by
    direction and device. Where they are missing, a call of BUILD_TICKS or
    more ticks builds them (``_blocks``, one more launch) and stores them in
    ``blocks``; a shorter one runs tick by tick. The state lives in
    registers and shared memory up to 1024 taps, in shared memory up to
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
    if not steps:
        new_state.copy_(state)
        return new_state, out
    F = _field(ops, state.device)
    nblk, lay = 0, None
    if k <= _BLOCK_MAX_TAPS and steps >= 2 * BLOCK_TICKS:
        key = (direction, str(state.device))
        lay = None if blocks is None else blocks.get(key)
        if lay is None and steps >= BUILD_TICKS:
            lay = _blocks(ops, taps, kind, direction, inv_tap, F)
            if blocks is not None:
                blocks[key] = lay
        if lay is not None:
            nblk = steps // BLOCK_TICKS
    D, G = lay if lay is not None else (None, None)
    _launch(state, taps, new_state, out, steps, kind, direction, inv_tap, F, D, G, nblk, 1)
    return new_state, out


def berlekamp_massey_long(ops, seq):
    """K13: ``berlekamp_massey_long_plain``'s (c, L) for one sequence (N,)
    of a field inside ``scan_supports``. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in
    ``berlekamp_massey_long.launches``) or raise. GF(2) takes BM_S steps a
    block on packed words; the other fields take the steps on warp 0 while c
    spans fewer than 256 elements (runs of d = 0 BM_S at a time), on the
    whole CTA after. The kernel stages the sequence, reversed, beside its
    buffers in shared memory (GF(2) up to N of about 350,000, the other
    fields about 14,000; ``BM_SMEM_BYTES`` lowers the budget), in a global
    scratch above."""
    if seq.device.type == "cpu":
        return berlekamp_massey_long_plain(ops, seq)
    _check("berlekamp_massey_long", ops, seq)
    if seq.ndim != 1 or not 1 <= seq.shape[0] <= BM_MAX_N:
        raise ValueError(f"berlekamp_massey_long: needs one sequence (N,), 1 <= N <= 2^28, got {tuple(seq.shape)}.")
    seq = seq.contiguous()
    N = seq.shape[0]
    c = torch.empty(N + 1, dtype=seq.dtype, device=seq.device)
    L = torch.empty((), dtype=torch.int64, device=seq.device)
    lib = _lib()
    fk, F = _field(ops, seq.device)
    budget = -1 if BM_SMEM_BYTES is None else BM_SMEM_BYTES
    words = lib.bm_long_scratch_words(N, fk, F.q1, budget)
    scratch = torch.empty(words, dtype=torch.int32, device=seq.device) if words else None
    with torch.cuda.device(seq.device):
        rc = lib.bm_long_launch(
            seq.data_ptr(), N, c.data_ptr(), L.data_ptr(), None if scratch is None else scratch.data_ptr(),
            int(seq.dtype == torch.uint8), fk, F, budget,
            ctypes.c_void_p(torch.cuda.current_stream(seq.device).cuda_stream),
        )
    if rc != 0:
        raise RuntimeError(f"berlekamp_massey_long: kernel launch failed with CUDA error {rc}.")
    berlekamp_massey_long.launches += 1
    return c, L


lfsr_step.launches = 0
berlekamp_massey_long.launches = 0
