"""Kernels K1 and K2: the NTT's fused balanced-plane prime matmuls.

Wrappers and plain versions for ``csrc/plane_matmul.cu`` (CUDA C++, built by
``_build.py`` for sm_90a and bound with ctypes). They replace
``plane_matmul_data_right`` and ``plane_matmul_data_left`` of
``galois_tpu/ops/_pallas/_plane_matmul.py``; the source file's head says
what bounds them on the H100 and how their design differs from the TPU's.

Each wrapper serves CPU tensors with its plain version and launches its
kernel for CUDA tensors, counting the launch in ``<wrapper>.launches``; it
raises on anything else. Tables come as raw (n, rows, cols) int8 planes
(``balanced_planes_np``); data and outputs are int64 residues in [0, p).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._kernels import mulmod
from ._linalg import _PLANE_MAXD, _prime_matmul_planes, balanced_plane_count

__all__ = [
    "supports",
    "plane_matmul_data_right",
    "plane_matmul_data_left",
    "plane_matmul_data_right_plain",
    "plane_matmul_data_left_plain",
]

# Plane counts the kernel is instantiated for. Below 3 planes (p < 2^16)
# the exactness gate below cannot hold for any K >= 2.
_KERNEL_PLANES = (3, 4, 5)


def supports(p: int, M: int, K: int, N: int) -> bool:
    """True when the kernels compute (M x K) @ (K x N) mod p exactly.

    The gate is the int32 bound on the diagonal sums, n * K * 128^2 <
    min(2^31, p), which also makes |D_s| < p for the fold. The kernel's
    shared memory is a fixed n * (64 + 32) * 80 bytes per block (at most
    38 KB), whatever the shape, so it adds no shape bound."""
    n_planes = balanced_plane_count(p)
    return (
        p < 2**32
        and n_planes in _KERNEL_PLANES
        and n_planes * K * _PLANE_MAXD**2 < min(2**31, p)
        and min(M, K, N) >= 1
    )


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def plane_matmul_data_right_plain(a_planes, x, p: int, twiddle=None) -> torch.Tensor:
    """(n, M, K) table planes @ (..., K, N) data -> (..., M, N), times the
    (M, N) twiddle mod p when given."""
    out = _prime_matmul_planes(None, x, p, x.shape[-2], a_planes=a_planes)
    return out if twiddle is None else mulmod(out, twiddle.to(torch.int64), p)


def plane_matmul_data_left_plain(x, b_planes, p: int, transpose_out: bool = False) -> torch.Tensor:
    """(..., M, K) data @ (n, K, N) table planes -> (..., M, N), or
    (..., N, M) with transpose_out."""
    out = _prime_matmul_planes(x, None, p, x.shape[-1], b_planes=b_planes)
    return out.transpose(-1, -2).contiguous() if transpose_out else out


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("plane_matmul")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.plane_matmul_data_right.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i64, vp]
    lib.plane_matmul_data_right.restype = i32
    lib.plane_matmul_data_left.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i64, i32, vp]
    lib.plane_matmul_data_left.restype = i32
    return lib


def _check_launch(fn: str, data, planes, p: int, M: int, K: int, N: int, batch: int):
    if planes.device != data.device:
        raise ValueError(f"{fn}: table planes on {planes.device}, data on {data.device}.")
    if data.dtype != torch.int64 or planes.dtype != torch.int8:
        raise TypeError(f"{fn}: needs int64 data and int8 planes, got {data.dtype}, {planes.dtype}.")
    if planes.ndim != 3 or planes.shape[0] != balanced_plane_count(p):
        raise ValueError(f"{fn}: planes of shape {tuple(planes.shape)} are not (n, rows, cols) for p = {p}.")
    if not supports(p, M, K, N):
        raise ValueError(f"{fn}: ({M} x {K}) @ ({K} x {N}) mod {p} is outside the kernel's exactness gate.")
    if not 1 <= batch <= 65535 or -(-M // 64) > 65535:
        raise ValueError(f"{fn}: batch {batch} or {M} rows exceed the kernel's grid.")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def plane_matmul_data_right(a_planes, x, p: int, twiddle=None) -> torch.Tensor:
    """K1: (n, M, K) int8 table planes @ (..., K, N) int64 data mod p ->
    (..., M, N) int64, times the (M, N) twiddle mod p when given (the NTT's
    side 1 with its twiddle stage fused into the epilogue)."""
    if x.device.type == "cpu":
        return plane_matmul_data_right_plain(a_planes, x, p, twiddle)
    if x.device.type != "cuda":
        raise ValueError(f"plane_matmul_data_right: unsupported device {x.device}.")
    batch_shape = x.shape[:-2]
    M, K, N = a_planes.shape[1], x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, K, N).contiguous()
    _check_launch("plane_matmul_data_right", xb, a_planes, p, M, K, N, xb.shape[0])
    if a_planes.shape[2] != K:
        raise ValueError(f"plane_matmul_data_right: planes {tuple(a_planes.shape)} vs data K = {K}.")
    if twiddle is not None:
        if twiddle.shape != (M, N) or twiddle.dtype != torch.int64 or twiddle.device != x.device:
            raise ValueError("plane_matmul_data_right: twiddle must be an (M, N) int64 tensor on the data's device.")
        twiddle = twiddle.contiguous()
    a_planes = a_planes.contiguous()
    out = torch.empty((xb.shape[0], M, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().plane_matmul_data_right(
            a_planes.data_ptr(), xb.data_ptr(), None if twiddle is None else twiddle.data_ptr(),
            out.data_ptr(), xb.shape[0], M, K, N, a_planes.shape[0], p, _stream(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"plane_matmul_data_right: kernel launch failed with CUDA error {rc}.")
    plane_matmul_data_right.launches += 1
    return out.reshape(batch_shape + (M, N))


def plane_matmul_data_left(x, b_planes, p: int, transpose_out: bool = False) -> torch.Tensor:
    """K2: (..., M, K) int64 data @ (n, K, N) int8 table planes mod p ->
    (..., M, N) int64, or (..., N, M) with each tile stored transposed (the
    NTT's side 2 with its final axis swap fused into the store)."""
    if x.device.type == "cpu":
        return plane_matmul_data_left_plain(x, b_planes, p, transpose_out)
    if x.device.type != "cuda":
        raise ValueError(f"plane_matmul_data_left: unsupported device {x.device}.")
    batch_shape = x.shape[:-2]
    M, K, N = x.shape[-2], x.shape[-1], b_planes.shape[2]
    xb = x.reshape(-1, M, K).contiguous()
    _check_launch("plane_matmul_data_left", xb, b_planes, p, M, K, N, xb.shape[0])
    if b_planes.shape[1] != K:
        raise ValueError(f"plane_matmul_data_left: planes {tuple(b_planes.shape)} vs data K = {K}.")
    b_planes = b_planes.contiguous()
    tail = (N, M) if transpose_out else (M, N)
    out = torch.empty((xb.shape[0],) + tail, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().plane_matmul_data_left(
            xb.data_ptr(), b_planes.data_ptr(), out.data_ptr(), xb.shape[0], M, K, N,
            b_planes.shape[0], p, int(transpose_out), _stream(x.device),
        )
    if rc != 0:
        raise RuntimeError(f"plane_matmul_data_left: kernel launch failed with CUDA error {rc}.")
    plane_matmul_data_left.launches += 1
    return out.reshape(batch_shape + tail)


plane_matmul_data_right.launches = 0
plane_matmul_data_left.launches = 0
