"""Kernels K1 and K2: the NTT's fused balanced-plane prime matmuls.

Wrappers and plain versions for ``csrc/plane_matmul.cu`` (CUDA C++, built by
``_build.py`` for sm_90a and bound with ctypes). They replace
``plane_matmul_data_right`` and ``plane_matmul_data_left`` of
``galois_tpu/ops/_pallas/_plane_matmul.py``; the source file's head says
what bounds them on the H100 and how their design differs from the TPU's.

Each wrapper serves CPU tensors with its plain version and launches its
kernels for CUDA tensors, counting the call in ``<wrapper>.launches``; it
raises on anything else. A call launches two kernels: ``plane_digits``, the
prologue that splits the int64 data into its K-major int8 planes, then the
wgmma GEMM. Data and outputs are int64 residues in [0, p).

Tables come either raw, as ``balanced_planes_np`` makes them ((n, M, K) for
K1, (n, K, N) for K2), or as ``KMajorPlanes``, the layout the kernel reads:
(n, rows, Kp), each row's K digits contiguous and zero padded to Kp, K
rounded up to 16. A raw table is repacked into that layout by every CUDA
call (a visible copy); ``MatmulFFTPlan`` keeps its tables K-major.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._kernels import mulmod
from ._linalg import _PLANE_MAXD, _balanced_planes, _prime_matmul_planes, balanced_plane_count

__all__ = [
    "KMajorPlanes",
    "kmajor_planes",
    "supports",
    "plane_digits",
    "plane_digits_plain",
    "plane_matmul_data_right",
    "plane_matmul_data_left",
    "plane_matmul_data_right_plain",
    "plane_matmul_data_left_plain",
]

# Plane counts the kernel is instantiated for. Below 3 planes (p < 2^16)
# the exactness gate below cannot hold for any K >= 2.
_KERNEL_PLANES = (3, 4, 5)
_K_ALIGN = 16  # TMA's global strides are multiples of 16 bytes


def supports(p: int, M: int, K: int, N: int) -> bool:
    """True when the kernels compute (M x K) @ (K x N) mod p exactly.

    The gate is the int32 bound on the diagonal sums, n * K * 128^2 <
    min(2^31, p), which also makes |D_s| < p for the fold. The kernel's
    tiles and ring are fixed per plane count, whatever the shape (TMA fills
    ragged edges with zeros), so it adds no shape bound."""
    n_planes = balanced_plane_count(p)
    return (
        p < 2**32
        and n_planes in _KERNEL_PLANES
        and n_planes * K * _PLANE_MAXD**2 < min(2**31, p)
        and min(M, K, N) >= 1
    )


def _padded(K: int) -> int:
    return -(-K // _K_ALIGN) * _K_ALIGN


@dataclasses.dataclass(frozen=True)
class KMajorPlanes:
    """A table's n balanced int8 planes as the kernels read them: ``planes``
    is (n, rows, Kp) with each row's ``K`` digits contiguous and zero padded
    to Kp = K rounded up to 16. rows are M for K1's table, N for K2's."""

    planes: torch.Tensor
    K: int

    def raw(self, k_axis: int) -> torch.Tensor:
        """The raw planes: (n, rows, K) for k_axis 2, (n, K, rows) for 1."""
        planes = self.planes[..., : self.K]
        return planes if k_axis == 2 else planes.transpose(1, 2)


def kmajor_planes(planes, k_axis: int) -> KMajorPlanes:
    """Raw (n, rows, K) (``k_axis`` 2, K1's table) or (n, K, cols)
    (``k_axis`` 1, K2's table) int8 planes -> their K-major copy."""
    if isinstance(planes, KMajorPlanes):
        return planes
    if planes.ndim != 3:
        raise ValueError(f"planes of shape {tuple(planes.shape)} are not (n, rows, cols).")
    rows_k = planes if k_axis == 2 else planes.transpose(1, 2)
    K = rows_k.shape[2]
    out = torch.zeros(rows_k.shape[:2] + (_padded(K),), dtype=planes.dtype, device=planes.device)
    out[..., :K] = rows_k
    return KMajorPlanes(out, K)


def _raw(planes, k_axis: int) -> torch.Tensor:
    return planes.raw(k_axis) if isinstance(planes, KMajorPlanes) else planes


def _table_k(planes, k_axis: int) -> int:
    return planes.K if isinstance(planes, KMajorPlanes) else planes.shape[k_axis]


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def plane_digits_plain(x, p: int, cols: bool = False) -> torch.Tensor:
    """The data operand's planes: (B, rows, K) int64 (or (B, K, rows) with
    ``cols``) -> (B, n, rows, Kp) int8, K-major, zero digits at k >= K."""
    rows_k = x.transpose(-1, -2) if cols else x
    B, R, K = rows_k.shape
    n = balanced_plane_count(p)
    out = torch.zeros((B, n, R, _padded(K)), dtype=torch.int8, device=x.device)
    out[..., :K] = _balanced_planes(rows_k, p, n).transpose(0, 1)
    return out


def plane_matmul_data_right_plain(a_planes, x, p: int, twiddle=None) -> torch.Tensor:
    """(n, M, K) table planes (raw or K-major) @ (..., K, N) data ->
    (..., M, N), times the (M, N) twiddle mod p when given."""
    out = _prime_matmul_planes(None, x, p, x.shape[-2], a_planes=_raw(a_planes, 2))
    return out if twiddle is None else mulmod(out, twiddle.to(torch.int64), p)


def plane_matmul_data_left_plain(x, b_planes, p: int, transpose_out: bool = False) -> torch.Tensor:
    """(..., M, K) data @ (n, K, N) table planes (raw or K-major) ->
    (..., M, N), or (..., N, M) with transpose_out."""
    out = _prime_matmul_planes(x, None, p, x.shape[-1], b_planes=_raw(b_planes, 1))
    return out.transpose(-1, -2).contiguous() if transpose_out else out


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("plane_matmul")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.plane_digits.argtypes = [vp, vp, i32, i32, i32, i32, i32, i64, i32, vp]
    lib.plane_digits.restype = i32
    lib.plane_matmul.argtypes = [vp, i32, vp, i32, vp, vp, i32, i32, i32, i32, i32, i64, i32, vp]
    lib.plane_matmul.restype = i32
    return lib


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(fn: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}.")


def plane_digits(x, p: int, cols: bool = False) -> torch.Tensor:
    """The prologue of K1 and K2: ``plane_digits_plain`` on the card."""
    if x.device.type == "cpu":
        return plane_digits_plain(x, p, cols)
    if x.device.type != "cuda" or x.dtype != torch.int64 or x.ndim != 3:
        raise ValueError(f"plane_digits: needs a (B, rows, K) int64 CUDA tensor, got {x.dtype} {tuple(x.shape)} on {x.device}.")
    n = balanced_plane_count(p)
    if n not in _KERNEL_PLANES:
        raise ValueError(f"plane_digits: no kernel for {n} planes (p = {p}).")
    x = x.contiguous()
    B, R, K = (x.shape[0], x.shape[2], x.shape[1]) if cols else x.shape
    out = torch.empty((B, n, R, _padded(K)), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().plane_digits(x.data_ptr(), out.data_ptr(), B, R, K, out.shape[-1], n, p, int(cols), _stream(x.device))
    _raise_on("plane_digits", rc)
    return out


def _check_launch(fn: str, data, table: KMajorPlanes, p: int, M: int, K: int, N: int, batch: int):
    planes = table.planes
    if planes.device != data.device:
        raise ValueError(f"{fn}: table planes on {planes.device}, data on {data.device}.")
    if data.dtype != torch.int64 or planes.dtype != torch.int8:
        raise TypeError(f"{fn}: needs int64 data and int8 planes, got {data.dtype}, {planes.dtype}.")
    if planes.ndim != 3 or planes.shape[0] != balanced_plane_count(p) or planes.shape[2] != _padded(K):
        raise ValueError(f"{fn}: planes of shape {tuple(planes.shape)} are not (n, rows, Kp) for p = {p}, K = {K}.")
    if not supports(p, M, K, N):
        raise ValueError(f"{fn}: ({M} x {K}) @ ({K} x {N}) mod {p} is outside the kernel's exactness gate.")
    if not 1 <= batch <= 65535:
        raise ValueError(f"{fn}: batch {batch} exceeds the kernel's grid.")
    if not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError(f"{fn}: K-major planes must be contiguous and 16-byte aligned.")


def plane_matmul_data_right(a_planes, x, p: int, twiddle=None) -> torch.Tensor:
    """K1: (n, M, K) int8 table planes (raw or ``KMajorPlanes``) @ (..., K, N)
    int64 data mod p -> (..., M, N) int64, times the (M, N) twiddle mod p
    when given (the NTT's side 1 with its twiddle stage fused into the
    epilogue)."""
    if x.device.type == "cpu":
        return plane_matmul_data_right_plain(a_planes, x, p, twiddle)
    if x.device.type != "cuda":
        raise ValueError(f"plane_matmul_data_right: unsupported device {x.device}.")
    if _table_k(a_planes, 2) != x.shape[-2]:
        raise ValueError(f"plane_matmul_data_right: table K = {_table_k(a_planes, 2)} vs data K = {x.shape[-2]}.")
    table = kmajor_planes(a_planes, 2)
    batch_shape = x.shape[:-2]
    M, K, N = table.planes.shape[1], x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, K, N).contiguous()
    _check_launch("plane_matmul_data_right", xb, table, p, M, K, N, xb.shape[0])
    if twiddle is not None:
        if twiddle.shape != (M, N) or twiddle.dtype != torch.int64 or twiddle.device != x.device:
            raise ValueError("plane_matmul_data_right: twiddle must be an (M, N) int64 tensor on the data's device.")
        twiddle = twiddle.contiguous()
    digits = plane_digits(xb, p, cols=True)  # (B, n, N, Kp)
    out = torch.empty((xb.shape[0], M, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().plane_matmul(
            table.planes.data_ptr(), 0, digits.data_ptr(), 1, None if twiddle is None else twiddle.data_ptr(),
            out.data_ptr(), xb.shape[0], M, N, digits.shape[-1], table.planes.shape[0], p, 0, _stream(x.device),
        )
    _raise_on("plane_matmul_data_right", rc)
    plane_matmul_data_right.launches += 1
    return out.reshape(batch_shape + (M, N))


def plane_matmul_data_left(x, b_planes, p: int, transpose_out: bool = False) -> torch.Tensor:
    """K2: (..., M, K) int64 data @ (n, K, N) int8 table planes (raw or
    ``KMajorPlanes``) mod p -> (..., M, N) int64, or (..., N, M) with each
    tile stored transposed (the NTT's side 2 with its final axis swap fused
    into the store)."""
    if x.device.type == "cpu":
        return plane_matmul_data_left_plain(x, b_planes, p, transpose_out)
    if x.device.type != "cuda":
        raise ValueError(f"plane_matmul_data_left: unsupported device {x.device}.")
    if _table_k(b_planes, 1) != x.shape[-1]:
        raise ValueError(f"plane_matmul_data_left: table K = {_table_k(b_planes, 1)} vs data K = {x.shape[-1]}.")
    table = kmajor_planes(b_planes, 1)
    batch_shape = x.shape[:-2]
    M, K, N = x.shape[-2], x.shape[-1], table.planes.shape[1]
    xb = x.reshape(-1, M, K).contiguous()
    _check_launch("plane_matmul_data_left", xb, table, p, M, K, N, xb.shape[0])
    digits = plane_digits(xb, p)  # (B, n, M, Kp)
    tail = (N, M) if transpose_out else (M, N)
    out = torch.empty((xb.shape[0],) + tail, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().plane_matmul(
            digits.data_ptr(), 1, table.planes.data_ptr(), 0, None, out.data_ptr(), xb.shape[0], M, N,
            digits.shape[-1], table.planes.shape[0], p, int(transpose_out), _stream(x.device),
        )
    _raise_on("plane_matmul_data_left", rc)
    plane_matmul_data_left.launches += 1
    return out.reshape(batch_shape + tail)


plane_matmul_data_right.launches = 0
plane_matmul_data_left.launches = 0
