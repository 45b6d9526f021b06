"""Sharded NTT over a ``torch.distributed`` device mesh: the 4-step
transform with its stage exchanges as all_to_all, and the batch-sharded
transform.

Port of ``galois_tpu/parallel/_ntt_sharded.py``. Four-step decomposition of
a size-N transform over the D ranks of a mesh dim (BASELINE config 5):
N = N1 * N2 with the input viewed column-major as v[n1, n2] = x[n2*N1 + n1]:

    X[k1*N2 + k2] = DFT_N1( twiddle(n1, k2) * DFT_N2(v[n1, :]) )

Each local DFT is the single-device plan (``ops/_ntt.py::_plan``) on the
rank's device; the transposes between them are ``all_to_all`` collectives
over the mesh dim. Each rank builds only its own N1/D rows of the twiddle
table.

SPMD, as JAX's ``shard_map``: every rank of the mesh calls the same function
with the same arguments. ``x`` is the whole array on every rank, as the JAX
caller passes one global array; the result is this rank's shard, laid out
as JAX's ``out_specs`` places it on that device, r being the rank's
coordinate on the mesh dim ``axis`` and D that dim's size:

- ``sharded_fft``: elements [r N/D, (r+1) N/D) of the transform, in natural
  order;
- ``sharded_batched_fft``: rows [r B/D, (r+1) B/D).

The result is a FieldArray when ``x`` was one, else a storage tensor; planar
storage keeps its storage axis leading (``fields/_meta.py``). Callers gather
shards with ``all_gather_into_tensor``. The rank's device is the mesh's
device type (the current CUDA card for a ``"cuda"`` mesh, which raises
without a card); inputs move there.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from ..fields._array import FieldArray, _ints_to_storage
from ..fields._hostfield import get_host_field
from ..fields._meta import FieldMeta
from ..ops._kernels import get_ops, kernel_mode
from ..ops._ntt import _divide_by_n, _get_omega, _multiply_chunked, _plan, _power_ladder
from ._mesh import all_gather, all_to_all, axis_info, local_shard, mesh_device

__all__ = ["sharded_fft", "sharded_batched_fft", "ShardedFFTPlan", "ShardingUnsupportedError"]

# Twiddle tables up to this N are built on the host, above it by doubling on the device.
_HOST_TWIDDLE_MAX = 2**20


class ShardingUnsupportedError(ValueError):
    """N cannot be 4-step sharded over this mesh axis (need D^2 | N)."""


class ShardedFFTPlan:
    """Plan for a size-N field FFT sharded over the mesh dim ``axis``: this
    rank's local plans and its rows of the twiddle table."""

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, mesh, axis: str):
        self.meta = meta
        self.N = N
        self.mesh = mesh
        self.axis = axis
        self.group, D, self.rank = axis_info(mesh, axis)
        self.D = D
        self.device = mesh_device(mesh)
        self.ops = get_ops(meta, mode)

        # Choose N1 ~ sqrt(N) (balanced local DFT sizes) subject to
        # D | N1 and D | N2 (required for the transposes).
        N1 = D
        target = math.isqrt(N)
        while N1 * 2 <= target and N % (N1 * 2) == 0 and (N // (N1 * 2)) % D == 0:
            N1 *= 2
        N2 = N // N1
        if N1 % D or N2 % D:
            raise ShardingUnsupportedError(f"Cannot shard N={N} over {D} devices (need D^2 | N).")
        self.N1, self.N2 = N1, N2

        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        # Local plans: row DFT of size N2 with root omega^N1; then size N1
        # with root omega^N2.
        self.plan2 = _plan(meta, N2, hf.power(omega_int, N1), mode, self.device)
        self.plan1 = _plan(meta, N1, hf.power(omega_int, N2), mode, self.device)
        self._omega_int = omega_int
        self._twiddle = None

    def _build_twiddle(self) -> torch.Tensor:
        """This rank's rows n1 in [r N1/D, (r+1) N1/D) of T[n1, k2] =
        omega^(n1 k2): gathered from the host power ladder up to
        ``_HOST_TWIDDLE_MAX``, above it filled on the device by doubling
        along k2 from the row seeds omega^n1."""
        if self._twiddle is not None:
            return self._twiddle
        meta, N, N2, omega = self.meta, self.N, self.N2, self._omega_int
        rows = self.N1 // self.D
        n1 = np.arange(self.rank * rows, (self.rank + 1) * rows, dtype=np.int64)
        if N <= _HOST_TWIDDLE_MAX:
            pw = _power_ladder(meta, omega, N)
            tw = _ints_to_storage(meta, pw[(n1[:, None] * np.arange(N2)[None, :]) % N], self.device)
        else:
            hf = get_host_field(meta)
            seed = _ints_to_storage(meta, np.array([hf.power(omega, int(k)) for k in n1], dtype=object), self.device)
            # T[:, 0] = 1; T[:, k] = seed^k, by doubling blocks
            cols = _ints_to_storage(meta, np.ones((rows, 1), dtype=np.int64), self.device)
            width, cur = 1, seed  # cur = seed^width
            while width < N2:
                take = min(width, N2 - width)
                blk = _multiply_chunked(self.ops, cols[..., :take], cur[..., None])
                cols = torch.cat([cols, blk], dim=-1)
                cur = _multiply_chunked(self.ops, cur, cur)
                width *= 2
            tw = cols
        self._twiddle = tw
        return tw

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: the whole (N,) or planar (w, N) storage tensor, on any device ->
        this rank's N/D elements of the transform, in natural order."""
        N, N1, N2, D, group = self.N, self.N1, self.N2, self.D, self.group
        lead = 1 if self.meta.storage_first else 0  # planar storage axis leads
        head = tuple(x.shape[:lead])
        tw = self._build_twiddle()
        # Global view: M[n2, n1] = x[n2*N1 + n1]; this rank holds N2/D rows.
        Ml = local_shard(x, lead, D, self.rank, self.device).reshape(head + (N2 // D, N1))
        # transpose 1: -> v rows n1 (N1/D, N2)
        vl = _transpose(Ml, D, group, lead)
        # local row DFT of size N2 (root omega^N1), then this rank's twiddle rows
        Bl = _multiply_chunked(self.ops, self.plan2.transform(vl), tw)
        # transpose 2: -> rows k2 (N2/D, N1); local row DFT of size N1 (root omega^N2)
        Xl = self.plan1.transform(_transpose(Bl, D, group, lead))
        # Xl[k2_local, k1] = X[k1*N2 + k2]; natural order puts X[r*N/D ...],
        # rows k1 of R[k1, k2] = X[k1*N2 + k2], on rank r
        Rl = _transpose(Xl, D, group, lead)  # rows k1: (N1/D, N2)
        return Rl.reshape(head + (N // D,))


def _transpose(Ml: torch.Tensor, D: int, group, lead: int = 0) -> torch.Tensor:
    """Distributed transpose.

    Ml: local ([w,] R/D, C) rows of a global (R, C) matrix — ``lead``
    leading axes (the planar storage axis) ride along untouched; returns
    local ([w,] C/D, R) rows of the transposed matrix."""
    RD, C = Ml.shape[lead], Ml.shape[lead + 1]
    head = tuple(Ml.shape[:lead])
    # split columns into D blocks -> (D, [w,] R/D, C/D); block e goes to rank e
    blocks = Ml.reshape(head + (RD, D, C // D)).movedim(lead + 1, 0)
    # block j of the result came from rank j: rows j*R/D.. of our column slab
    recv = all_to_all(blocks, group).movedim(0, lead)
    # assemble (R, C/D), then transpose rows <-> cols
    return recv.reshape(head + (D * RD, C // D)).transpose(lead, lead + 1)


@functools.lru_cache(maxsize=32)
def _sharded_plan(meta, N, omega, mode, mesh, axis):
    return ShardedFFTPlan(meta, N, omega, mode, mesh, axis)


@functools.lru_cache(maxsize=32)
def _replicated_fallback_fn(meta, N, omega, mode, mesh, axis):
    """Fallback when D^2 does not divide N (but D | N): all_gather the
    shards, run the full single-device plan redundantly on every rank, keep
    only the local output shard. Correct for any N the local plan supports;
    communication is one all_gather instead of the all_to_alls."""
    group, D, r = axis_info(mesh, axis)
    device = mesh_device(mesh)
    plan = _plan(meta, N, omega, mode, device)
    e_ax = 1 if meta.storage_first else 0  # element axis under a planar lead

    def run(data: torch.Tensor) -> torch.Tensor:
        xl = local_shard(data, e_ax, D, r, device)
        full = all_gather(xl, group, D).movedim(0, e_ax).reshape(tuple(xl.shape[:e_ax]) + (N,))
        return plan.transform(full).narrow(e_ax, r * (N // D), N // D)

    return run


def sharded_batched_fft(field_cls, x, mesh, axis: str = "x", inverse: bool = False):
    """Batched NTT with the BATCH axis sharded over the mesh: x is (B, N)
    (planar: (w, B, N)) with B = D * b rows; every rank transforms its own
    rows with the single-device plan — embarrassingly parallel, zero
    collectives (the reference's analogue is the prange batch loop,
    src/galois/_domains/_function.py:247-384)."""
    meta = field_cls._meta
    mode = kernel_mode(field_cls)
    data = x._data if isinstance(x, FieldArray) else x
    lead = 1 if meta.storage_first else 0
    if data.ndim < 2 + lead:
        raise ValueError("sharded_batched_fft expects a (batch, N) array.")
    B, N = data.shape[lead], data.shape[lead + 1]
    _, D, r = axis_info(mesh, axis)
    if B % D:
        raise ValueError(f"Batch {B} must be divisible by the mesh axis size {D}.")
    omega = _get_omega(field_cls, N)
    if inverse:
        omega = get_host_field(meta).reciprocal(omega)
    device = mesh_device(mesh)
    out = _plan(meta, N, omega, mode, device).transform(local_shard(data, lead, D, r, device))
    if inverse:
        out = _divide_by_n(field_cls, out, N)
    if isinstance(x, FieldArray):
        return field_cls._view(out, x._dtype)
    return out


def sharded_fft(field_cls, x, mesh, axis: str = "x", inverse: bool = False):
    """Transform a 1-D FieldArray (or storage tensor) of size N over the mesh.

    Uses the all-to-all 4-step plan when D^2 | N; falls back to the
    replicated all_gather path, with a RuntimeWarning, when only D | N."""
    meta = field_cls._meta
    mode = kernel_mode(field_cls)
    data = x._data if isinstance(x, FieldArray) else x
    N = data.shape[1 if meta.storage_first else 0]
    omega = _get_omega(field_cls, N)
    if inverse:
        omega = get_host_field(meta).reciprocal(omega)
    _, D, _ = axis_info(mesh, axis)
    if N % D:
        raise ValueError(f"N={N} must at least be divisible by the mesh axis size {D}.")
    try:
        plan = _sharded_plan(meta, N, omega, mode, mesh, axis)
    except ShardingUnsupportedError:
        # Loud by design: the replicated path is correct but gives ZERO
        # speedup (every rank runs the full transform). Only the D^2
        # divisibility rejection routes here.
        warnings.warn(
            f"sharded_fft: N={N} is not 4-step shardable over {D} devices "
            f"(need D^2 | N); falling back to a REPLICATED transform with no "
            f"speedup. Pick N with D^2 | N to scale.",
            RuntimeWarning,
            stacklevel=2,
        )
        out = _replicated_fallback_fn(meta, N, omega, mode, mesh, axis)(data)
    else:
        out = plan(data)
    if inverse:
        out = _divide_by_n(field_cls, out, N)
    if isinstance(x, FieldArray):
        return field_cls._view(out, x._dtype)
    return out
