"""GF(2^m) products with a constant matrix as one GF(2)-linear map (kernel K15).

Over GF(2^m), X -> X @ M is GF(2)-linear in X's bits. Writing an element as
its m bits, M expands once into a (K m, N m) 0/1 map T: block (k, n) of T is
the m x m matrix of multiplication by M[k, n], so row k m + i, column n m + o
holds bit o of x^i M[k, n]. The product's bits are then the parities of
bits(X) @ T: the same multiply-adds as the stacked bit-plane product of
``ops/_binary_matmul.py``, with no block XORs and no fold by f.

Every product of the RS/BCH decoder has a constant of the code on the right
(``codes/_decoder.py``: W, Vinv_T, CH_T, CHn_T). ``linear_map`` expands it on
the host, once per code; ``pack_map`` lays T out in the order the kernel's
int8 mma fragments read it, padded to the tiles; the decoder copies that once
to each device. ``gf2_linear`` is then one launch of K15
(``csrc/gf2_linear.cu``) a product: X's storage read once, the product's
storage written once, no plane or sum in device memory. Its plain version,
which CPU tensors run, is the same map in torch: ``parity(bits(X) @ T)`` in
float32 (exact: the sums are at most K m <= 2^14 < 2^24), in row chunks of at
most 2^25 float32 elements a tensor, with T unpacked once per packed map.

No Pallas kernel is replaced: the JAX package runs these products as a
``jnp.matmul`` of bit planes, as the public ``matmul`` of both packages still
does, where both operands are data and a map of one would be too large
(``supports`` bounds the map's bytes).

The wrapper runs inside a ``gf.binary_matmul`` span (``_tracing.py``), the
name of the layer of bit-plane products, which its readers keep.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from .._tracing import span
from ..fields._meta import STORAGE_INT, FieldMeta

__all__ = [
    "NT", "MAX_MAP_BYTES", "geometry", "supports", "linear_map", "pack_map", "unpack_map", "gf2_linear",
    "gf2_linear_plain",
]

NT = 8  # n8 tiles a warp's pass (csrc/gf2_linear.cu: NT)
MAX_MAP_BYTES = 64 << 20  # the largest packed map a constant may take
MAX_BITS = 2**14  # K m and N m: a warp's 32 rows of bit strings fit the shared memory
_CHUNK_ELEMS = 2**25  # float32 elements of the plain version's bits or sums, a row chunk
_plain_maps: dict = {}  # id(frags) -> (weak reference to frags, its version, T in float32)


def geometry(k: int, n: int, m: int) -> tuple:
    """(ks, groups): 32-bit k-steps over K m input bits, and passes of NT
    n8 tiles over N m output bits."""
    return -(-k * m // 32), -(-(-(-n * m // 8)) // NT)


def map_bytes(k: int, n: int, m: int) -> int:
    ks, groups = geometry(k, n, m)
    return 32 * ks * 8 * NT * groups


def supports(meta: FieldMeta, k: int, n: int) -> bool:
    """Whether a (k, n) constant of ``meta`` takes K15: GF(2^m), 2 <= m <= 16,
    int storage, K m and N m up to 2^14 and a packed map up to 64 MB."""
    m = meta.degree
    return (
        meta.characteristic == 2
        and meta.storage == STORAGE_INT
        and 2 <= m <= 16
        and 0 < k * m <= MAX_BITS
        and 0 < n * m <= MAX_BITS
        and map_bytes(k, n, m) <= MAX_MAP_BYTES
    )


def linear_map(meta: FieldMeta, M: np.ndarray) -> np.ndarray:
    """T, (K m, N m) 0/1 int8: row k m + i, column n m + o holds bit o of
    x^i M[k, n]. Built with numpy, m shifts by x and folds by f."""
    m, f = meta.degree, meta.irreducible_poly_int
    v = np.asarray(M, dtype=np.int64)
    k, n = v.shape
    shifts = []
    for _ in range(m):  # x^i M
        shifts.append(v)
        v = v << 1
        v = np.where((v >> m) & 1, v ^ f, v)
    P = np.stack(shifts, axis=1)  # (K, m, N): x^i M[k, n]
    bits = (P[..., None] >> np.arange(m)) & 1  # (K, m, N, m)
    return bits.reshape(k * m, n * m).astype(np.int8)


def pack_map(T: np.ndarray, m: int) -> np.ndarray:
    """T in the kernel's fragment order, (groups, ks, NT, 32, 8) int8, zero
    padded to ks 32-bit k-steps and groups of NT n8 tiles. Fragment (group,
    s, j), lane 4 g + t: bytes 0-3 are rows 32 s + 4 t + 0..3 of column
    64 group + 8 j + g, bytes 4-7 rows 32 s + 16 + 4 t + 0..3 (the B operand
    of mma.m16n8k32)."""
    km, nm = T.shape
    ks, groups = geometry(km // m, nm // m, m)
    Tp = np.zeros((32 * ks, 8 * NT * groups), dtype=np.int8)
    Tp[:km, :nm] = T
    # rows (s, h, t, jb), columns (group, j, g) -> (group, s, j, g, t, h, jb)
    F = Tp.reshape(ks, 2, 4, 4, groups, NT, 8).transpose(4, 0, 5, 6, 2, 1, 3)
    return np.ascontiguousarray(F).reshape(groups, ks, NT, 32, 8)


def unpack_map(frags: torch.Tensor) -> torch.Tensor:
    """The padded (32 ks, 64 groups) map from ``pack_map``'s layout."""
    groups, ks = frags.shape[:2]
    F = frags.reshape(groups, ks, NT, 8, 4, 2, 4)
    return F.permute(1, 5, 4, 6, 0, 2, 3).reshape(32 * ks, 8 * NT * groups)


def _check(x: torch.Tensor, frags: torch.Tensor, m: int, n: int) -> None:
    if x.ndim != 2 or not 2 <= m <= 16 or x.dtype != (torch.uint8 if m <= 8 else torch.int64):
        raise ValueError(
            f"gf2_linear: x of shape {tuple(x.shape)}, {x.dtype}, m={m}: need (rows, K) storage of GF(2^m)."
        )
    ks, groups = geometry(x.shape[1], n, m)
    if frags.dtype != torch.int8 or tuple(frags.shape) != (groups, ks, NT, 32, 8) or frags.device != x.device:
        raise ValueError(
            f"gf2_linear: a map of shape {tuple(frags.shape)} on {frags.device} "
            f"for a ({x.shape[1]}, {n}) constant on {x.device}."
        )


def _plain_map(frags: torch.Tensor) -> torch.Tensor:
    """``unpack_map(frags)`` in float32, kept while ``frags`` lives unchanged."""
    key = id(frags)
    hit = _plain_maps.get(key)
    if hit is None or hit[0]() is not frags or hit[1] != frags._version:
        ref = weakref.ref(frags, lambda _, key=key: _plain_maps.pop(key, None))
        hit = _plain_maps[key] = (ref, frags._version, unpack_map(frags).to(torch.float32))
    return hit[2]


def gf2_linear_plain(x: torch.Tensor, frags: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """K15's map in torch, on any device: parity(bits(x) @ T) in float32,
    in row chunks."""
    _check(x, frags, m, n)
    rows, k = x.shape
    T = _plain_map(frags)[: k * m, : n * m]
    shifts = torch.arange(m, dtype=torch.int32, device=x.device)
    step = max(1, _CHUNK_ELEMS // (max(k, n) * m))
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    for s in range(0, rows, step):
        bits = ((x[s : s + step].to(torch.int32)[..., None] >> shifts) & 1).reshape(-1, k * m)
        par = torch.matmul(bits.to(torch.float32), T).to(torch.int32) & 1
        out[s : s + step] = (par.reshape(-1, n, m) << shifts).sum(-1).to(x.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("gf2_linear")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.gf2_linear_u8, lib.gf2_linear_i64):
        fn.argtypes = [vp, i64, i64, i32, i32, vp, i32, i32, vp, i32, vp]
        fn.restype = ctypes.c_int
    return lib


def gf2_linear(x: torch.Tensor, frags: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """K15: x (rows, K) @ M (K, n) over GF(2^m), M given by its packed map
    ``frags`` (``pack_map(linear_map(meta, M), m)`` on x's device); returns
    (rows, n) in x's dtype.

    CPU tensors take ``gf2_linear_plain``; CUDA tensors launch the kernel
    (counted in ``gf2_linear.launches``) or raise. Rows are read at their
    stride where the inner one is 1."""
    with span("gf.binary_matmul", x):
        if x.device.type == "cpu":
            return gf2_linear_plain(x, frags, m, n)
        if x.device.type != "cuda":
            raise ValueError(f"gf2_linear: x on {x.device}; need a CUDA device or the CPU.")
        _check(x, frags, m, n)
        if not frags.is_contiguous():
            raise ValueError("gf2_linear: the packed map must be contiguous.")
        rows, k = x.shape
        if x.stride(1) != 1 or (rows > 1 and x.stride(0) < k):
            x = x.contiguous()
        out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
        if rows:
            ks, groups = geometry(k, n, m)
            entry = _lib().gf2_linear_u8 if m <= 8 else _lib().gf2_linear_i64
            with torch.cuda.device(x.device):
                rc = entry(
                    x.data_ptr(), rows, x.stride(0) if rows > 1 else k, k, m, frags.data_ptr(), ks, groups,
                    out.data_ptr(), n, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
                )
            if rc != 0:
                raise RuntimeError(f"gf2_linear: kernel launch failed with CUDA error {rc}.")
            gf2_linear.launches += 1
        return out


gf2_linear.launches = 0
