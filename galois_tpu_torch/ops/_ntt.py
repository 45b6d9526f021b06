"""Number-theoretic transform / finite-field FFT.

Port of ``galois_tpu/ops/_ntt.py``. ``_plan`` picks, per (field, N, omega,
device):

- ``MatmulFFTPlan`` for prime fields, int or planar limb storage, whose N
  splits into two factors <= 4096, or, for larger 4096-smooth N, into a
  factor <= 4096 and one that is itself a recursive 6-step sub-plan: the
  4-step NTT as two exact modular matmuls around a twiddle multiply.
  - int storage: where the side kernels' gate holds
    (``_plane_matmul.supports``), a direct side 1 is kernel K1 with the
    twiddle fused in and a direct side 2 is kernel K2 with a transposed
    store, as on the TPU; otherwise the plain plane matmul of
    ``_linalg.py``.
  - limb storage (Goldilocks, BLS12-381's scalar field, ...): the sides are
    ``ops/_limb_matmul.py``; the tables are gathered on the device from
    three power ladders of length <= 4096 (the factored tables).
- ``FFTPlan``, the direct-DFT and mixed-radix Cooley-Tukey path, for
  N <= 64, non-prime fields and N without such a split.

Plans hold their tables as tensors on the device they were built for.
Host tables of int-storage plans are built with vectorized NumPy uint64
modular arithmetic (residues < 2^32, so products < 2^64).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from .._tracing import span
from ..fields._array import _ints_to_limbs, _ints_to_storage
from ..fields._hostfield import get_host_field
from ..fields._meta import STORAGE_INT, STORAGE_LIMBS, FieldMeta
from ..nt import factors as int_factors
from ._kernels import get_ops, kernel_mode, mulmod
from ._limb_matmul import limb_matmul
from ._limb_matmul import supports_any as _limb_supports
from ._limbs import align_planar
from ._linalg import _prime_matmul, balanced_planes_np
from ._plane_matmul import kmajor_planes, plane_matmul_data_left, plane_matmul_data_right, supports

__all__ = ["fft_data", "field_fft", "field_ifft", "FFTPlan", "MatmulFFTPlan"]

_MAX_BASE = 64  # transforms at or below this size use a direct DFT
# A DFT factor above this size is itself a recursive 6-step sub-plan; factors
# up to it stay one direct matmul. Recursion serves the N that no two-factor
# split <= 4096 reaches (N > 2^24).
_RECURSE_ABOVE = 4096
# Memory budget of one chunk of a wide-limb elementwise multiply
# (``_multiply_chunked``): ``LimbPrimeOps.multiply`` holds about 96 L bytes
# of int64 limb planes an element (the widened operands, the 2L-limb
# product, Barrett's products and their carries).
_MUL_BYTES = 2**31


def _radix_schedule(N: int) -> List[int]:
    """Factor N into a list of radices, largest-first, leaving a base <= 64."""
    primes, exponents = int_factors(N)
    fs: List[int] = []
    for p, e in zip(primes, exponents):
        fs += [p] * e
    radices: List[int] = []
    cur = 1
    for f in sorted(fs):
        if cur * f <= _MAX_BASE:
            cur *= f
        else:
            radices.append(cur)
            cur = f
    if cur > 1:
        radices.append(cur)
    return sorted(radices, reverse=True)


def _power_ladder(meta: FieldMeta, g: int, n: int) -> np.ndarray:
    """[g^0, g^1, ..., g^(n-1)] as int reprs: int64, or Python ints (object)
    for limb fields.

    Prime fields below 2^32 double the filled prefix with NumPy uint64
    products (both factors < p); other fields step with exact host
    arithmetic."""
    if meta.is_prime_field and meta.characteristic < 2**32:
        p = meta.characteristic
        out = np.empty(n, dtype=np.uint64)
        out[0] = 1
        filled, g_filled = 1, g % p  # invariant: g_filled = g^filled
        while filled < n:
            take = min(filled, n - filled)
            out[filled : filled + take] = out[:take] * np.uint64(g_filled) % np.uint64(p)
            filled += take
            g_filled = g_filled * g_filled % p
        return out.astype(np.int64)
    hf = get_host_field(meta)
    out = np.empty(n, dtype=object if meta.storage == STORAGE_LIMBS else np.int64)
    cur = 1
    for k in range(n):
        out[k] = cur
        cur = hf.multiply(cur, g)
    return out


def _multiply_chunked(ops, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.multiply(a, b)`` (b broadcasts against a). Planar fields wider
    than 4 limbs or digits run it in chunks along the longest element axis,
    so that the product's int64 limb planes stay within ``_MUL_BYTES``;
    Goldilocks is kernel K10, which holds no such planes."""
    if ops.meta.storage == STORAGE_INT or a.shape[0] <= 4:
        return ops.multiply(a, b)
    w = a.shape[0]
    a, b = align_planar(a, b)
    shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    if not shape:
        return ops.multiply(a, b)
    d = 1 + max(range(len(shape)), key=lambda i: shape[i])
    n = shape[d - 1]
    step = max(1, _MUL_BYTES // (96 * w * (int(np.prod(shape)) // n)))
    if step >= n:
        return ops.multiply(a, b)
    out = torch.empty((w,) + shape, dtype=a.dtype, device=a.device)
    for r0 in range(0, n, step):
        r = min(step, n - r0)
        pa = a.narrow(d, r0, r) if a.shape[d] > 1 else a
        pb = b.narrow(d, r0, r) if b.shape[d] > 1 else b
        out.narrow(d, r0, r).copy_(ops.multiply(pa, pb))
    return out


class FFTPlan:
    """Precomputed tables for a size-N field FFT over GF(q) (N | q-1):
    mixed-radix recursion with direct-DFT contractions of radix <= 64.
    Planar limb storage rides through with its limb axis leading."""

    # Cap on materialized product elements in a contraction; bigger
    # workloads loop over j-chunks.
    _CONTRACT_BUDGET = 2**27

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, device):
        self.meta = meta
        self.N = N
        self.ops = get_ops(meta, mode)
        self.device = torch.device(device)
        if get_host_field(meta).power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        self.pw = _power_ladder(meta, omega_int, N)

        # Per level: (r, M, twiddle (M, r), W (r, r)) as storage tensors.
        self.levels = []
        radices = _radix_schedule(N)
        size, stride = N, 1
        for r in radices[:-1]:
            M = size // r
            k = np.arange(M).reshape(-1, 1)
            j = np.arange(r).reshape(1, -1)
            twiddle = self._gather((k * j * stride) % N)
            W = self._dft_matrix(r, stride=stride * M)
            self.levels.append((r, M, twiddle, W))
            size = M
            stride *= r
        self.base_W = self._dft_matrix(size, stride=stride)

    def _gather(self, idx: np.ndarray) -> torch.Tensor:
        return _ints_to_storage(self.meta, self.pw[idx], self.device)

    def _dft_matrix(self, n: int, stride: int) -> torch.Tensor:
        s = np.arange(n).reshape(-1, 1)
        j = np.arange(n).reshape(1, -1)
        return self._gather((s * j * stride) % self.N)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Transform the trailing axis of a storage tensor."""
        ops = self.ops

        def rec(x, level: int):
            if level == len(self.levels):
                return self._apply_dft(x, self.base_W)
            r, M, twiddle, W = self.levels[level]
            # x[n], n = r*m + j  ->  (..., r, M)
            xr = x.reshape(x.shape[:-1] + (M, r)).movedim(-1, -2)
            y = rec(xr, level + 1).movedim(-2, -1)  # (..., M, r)
            z = ops.multiply(y, twiddle)
            return self._contract(z, W)

        return rec(x, 0)

    def _chunk(self, numel: int, n: int) -> int:
        chunk = n
        while chunk > 1 and numel // n * chunk > self._CONTRACT_BUDGET:
            chunk //= 2
        return chunk

    def _apply_dft(self, x, W):
        """x: (..., n); W: (n, n). Returns X[s] = sum_j W[s,j] x[j]."""
        ops = self.ops
        n = x.shape[-1]
        chunk = self._chunk(x.numel() * n, n)
        out = None
        for j0 in range(0, n, chunk):
            prod = ops.multiply(x[..., j0 : j0 + chunk].unsqueeze(-2), W[..., j0 : j0 + chunk])
            part = _field_sum(ops, prod)
            out = part if out is None else ops.add(out, part)
        return out

    def _contract(self, z, W):
        """z: (..., M, r); W: (r, r). X[s*M + k] = sum_j z[k,j] W[s,j];
        output flattened to (..., r*M) with s major."""
        ops = self.ops
        r = z.shape[-1]
        chunk = self._chunk(z.numel() * r, r)
        out = None
        for j0 in range(0, r, chunk):
            zj = z[..., j0 : j0 + chunk].unsqueeze(-3)  # (..., 1, M, c)
            Wj = W[..., j0 : j0 + chunk].unsqueeze(-2)  # (r, 1, c)
            part = _field_sum(ops, ops.multiply(zj, Wj))  # (..., r, M)
            out = part if out is None else ops.add(out, part)
        return out.reshape(out.shape[:-2] + (out.shape[-2] * out.shape[-1],))


def _field_sum(ops, x):
    """Reduce the trailing axis with field addition via a binary tree."""
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        x = torch.cat([ops.add(x[..., :half], x[..., half : 2 * half]), x[..., 2 * half : n]], dim=-1)
        n = half + (n - 2 * half)
    return x[..., 0]


def _matmul_split(N: int):
    """Divisor N1 of N closest to sqrt(N) with N1 and N/N1 both <= 4096
    (bounds each DFT table at 4096^2); None if no such split exists or N
    is too small to benefit."""
    if N <= _MAX_BASE:
        return None
    best = None
    d = 1
    while d * d <= N:
        if N % d == 0:
            for n1 in (d, N // d):
                n2 = N // n1
                if n1 <= 4096 and n2 <= 4096 and n1 > 1 and n2 > 1:
                    score = abs(n1 * n1 - N)
                    if best is None or score < best[0]:
                        best = (score, n1)
        d += 1
    return None if best is None else best[1]


def _balanced_split(K: int):
    """Largest divisor of K that is <= sqrt(K); None if K is prime."""
    best = None
    d = 2
    while d * d <= K:
        if K % d == 0:
            best = d
        d += 1
    return best


def _largest_divisor_le(K: int, cap: int):
    """Largest divisor of K that is <= cap; None if only 1 qualifies."""
    best = None
    d = 1
    while d * d <= K:
        if K % d == 0:
            for c in (d, K // d):
                if 1 < c <= cap and (best is None or c > best):
                    best = c
        d += 1
    return best


class MatmulFFTPlan:
    """Single-device 4-step NTT for prime fields.

    X[k1 + N1*k2] = sum_{n2} W2[n2,k2] * ( T[k1,n2] * sum_{n1} W1[k1,n1] *
    M[n1,n2] ) with M[n1,n2] = x[n1*N2 + n2]: two exact modular matmuls
    around one elementwise twiddle. A side whose factor exceeds
    ``_RECURSE_ABOVE`` is a recursive sub-plan over omega^(N/factor)
    (``sub1``, ``sub2``) instead of a direct table.

    int storage: ``W1``, ``T`` and ``W2`` are the host tables in the JAX
    package's layout and dtype (``meta.internal_dtype``; None for a side that
    is a sub-plan); ``load_tables`` installs a set of them as this plan's
    device tensors, W1 and W2 as their balanced int8 planes.

    limb storage (``factored``): the plan keeps the three ladders ``lad_hi``
    (omega^n2, length n1), ``lad_lo`` (omega, length n2) and ``lad_w2``
    (omega^n1, length n2; None when side 2 is a sub-plan) as planar host
    limbs, as the JAX package's plan does, and gathers W1[k,j] =
    lad_hi[kj mod n1], W2 likewise, and T[k,j] = lad_hi[kj // n2] *
    lad_lo[kj mod n2] on the device.
    """

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, n1: int, device):
        self.meta = meta
        self.N = N
        self.n1 = n1
        self.n2 = n2 = N // n1
        self.ops = get_ops(meta, mode)
        self.device = torch.device(device)
        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        self.factored = meta.storage == STORAGE_LIMBS
        if self.factored and N >= 2**31:
            # the JAX package gathers with int32 indices k*j < N
            raise ValueError(f"Factored-table NTT plans require N < 2^31, got N = {N}.")
        self.sub1 = self.sub2 = None
        s1 = _balanced_split(n1) if n1 > _RECURSE_ABOVE else None
        if s1 is not None:
            self.sub1 = MatmulFFTPlan(meta, n1, hf.power(omega_int, n2), mode, s1, device)
        s2 = _balanced_split(n2) if n2 > _RECURSE_ABOVE else None
        if s2 is not None:
            self.sub2 = MatmulFFTPlan(meta, n2, hf.power(omega_int, n1), mode, s2, device)
        # W1[k, j] = omega^(n2*k*j mod N) = (omega^n2)^(k*j mod n1); likewise
        # W2 with omega^n1. T[k, j] = omega^(k*j), k*j = q*n2 + r, is
        # (omega^n2)^q * omega^r: every table gathers from ladders of
        # length <= 4096 (<= the larger factor with a sub-plan).
        lad_hi = _power_ladder(meta, hf.power(omega_int, n2), n1)
        lad_lo = _power_ladder(meta, omega_int, n2)
        lad_w2 = _power_ladder(meta, hf.power(omega_int, n1), n2) if self.sub2 is None else None
        if self.factored:
            L = meta.storage_width
            self.lad_hi, self.lad_lo = _ints_to_limbs(L, lad_hi), _ints_to_limbs(L, lad_lo)
            self.lad_w2 = None if lad_w2 is None else _ints_to_limbs(L, lad_w2)
            self._factored_tables()
            return
        p = meta.characteristic
        k1 = np.arange(n1, dtype=np.int64)
        k2 = np.arange(n2, dtype=np.int64)
        kj = k1[:, None] * k2[None, :]
        T = lad_hi.astype(np.uint64)[kj // n2] * lad_lo.astype(np.uint64)[kj % n2] % np.uint64(p)
        W1 = None if self.sub1 is not None else lad_hi[(k1[:, None] * k1[None, :]) % n1]
        W2 = None if self.sub2 is not None else lad_w2[(k2[:, None] * k2[None, :]) % n2]
        self.load_tables(W1, T, W2)

    def _factored_tables(self) -> None:
        """W1 (w, n1, n1), T (w, n1, n2) and W2 (w, n2, n2) on the device,
        gathered from the ladders; T is one chunked limb multiply."""
        dev, n1, n2 = self.device, self.n1, self.n2

        def take(ladder, idx):
            # CUDA has no uint16 gather: gather the same bits as int16
            return torch.from_numpy(ladder.view(np.int16)).to(dev)[:, idx].view(torch.uint16)

        k1 = torch.arange(n1, dtype=torch.int64, device=dev)
        k2 = torch.arange(n2, dtype=torch.int64, device=dev)
        self.w1 = None if self.sub1 is not None else take(self.lad_hi, (k1[:, None] * k1[None, :]) % n1)
        self.w2 = None if self.sub2 is not None else take(self.lad_w2, (k2[:, None] * k2[None, :]) % n2)
        kj = k1[:, None] * k2[None, :]  # < N
        self.t = _multiply_chunked(self.ops, take(self.lad_hi, kj // n2), take(self.lad_lo, kj % n2))

    def load_tables(self, W1, T: np.ndarray, W2) -> None:
        """Install host tables (e.g. ``plan.W1, plan.T, plan.W2`` of the JAX
        package's plan for the same field, N and omega; None for a side that
        is a sub-plan) as this plan's device tensors: W1 and W2 as their
        balanced int8 planes, T as int64."""
        n1, n2, p = self.n1, self.n2, self.meta.characteristic
        W1, T, W2 = (None if t is None else np.asarray(t).astype(self.meta.internal_dtype) for t in (W1, T, W2))
        want = (None if self.sub1 else (n1, n1), (n1, n2), None if self.sub2 else (n2, n2))
        got = tuple(None if t is None else t.shape for t in (W1, T, W2))
        if got != want:
            raise ValueError(f"Tables of shapes {got} do not fit a {n1} x {n2} plan (want {want}).")
        self.W1, self.T, self.W2 = W1, T, W2
        self.t = torch.from_numpy(T.astype(np.int64)).to(self.device)
        # the side kernels, as the JAX package's gate: both side shapes
        # inside it, and the side a direct table
        ok = supports(p, n1, n1, n2) and supports(p, n1, n2, n2)
        self.kernel1, self.kernel2 = ok and self.sub1 is None, ok and self.sub2 is None
        self.kernel_sides = self.kernel1 and self.kernel2
        self.w1_planes = self.w2_planes = None
        if W1 is not None:
            self.w1_planes = torch.from_numpy(balanced_planes_np(W1, p)).to(self.device)
            if self.kernel1:
                # the layout K1 reads: W1 (n, k1, n1), K padded to 16
                self.w1_planes = kmajor_planes(self.w1_planes, 2)
        if W2 is not None:
            self.w2_planes = torch.from_numpy(balanced_planes_np(W2, p)).to(self.device)
            if self.kernel2:
                # the layout K2 reads: W2 (n, k2, n2), K padded to 16
                self.w2_planes = kmajor_planes(self.w2_planes, 1)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Transform the trailing axis of a storage tensor."""
        if self.factored:
            return self._transform_limbs(x)
        p, n1, n2 = self.meta.characteristic, self.n1, self.n2
        batch = x.shape[:-1]
        M = x.reshape(batch + (n1, n2)).to(torch.int64)
        if self.sub1 is not None:
            A = self.sub1.transform(M.transpose(-1, -2)).transpose(-1, -2).to(torch.int64)
            B = mulmod(A, self.t, p)
        elif self.kernel1:
            # side 1 fuses the twiddle into its epilogue
            B = plane_matmul_data_right(self.w1_planes, M, p, twiddle=self.t)
        else:
            B = mulmod(_prime_matmul(None, M, p, n1, a_planes=self.w1_planes), self.t, p)
        if self.sub2 is not None:
            X = self.sub2.transform(B).transpose(-1, -2)
        elif self.kernel2:
            # side 2 stores its tiles transposed: the (k1, k2) -> (k2, k1) swap is free
            X = plane_matmul_data_left(B, self.w2_planes, p, transpose_out=True)
        else:
            X = _prime_matmul(B, None, p, n2, b_planes=self.w2_planes).transpose(-1, -2)
        return X.reshape(batch + (self.N,)).to(self.meta.torch_dtype)

    def _transform_limbs(self, x: torch.Tensor) -> torch.Tensor:
        """The 4-step on planar (w, ..., N) limbs: the limb axis rides as a
        batch axis, the sides are limb matmuls."""
        batch = x.shape[:-1]  # includes the leading (w,)
        M = x.reshape(batch + (self.n1, self.n2))
        if self.sub1 is not None:
            A = self.sub1.transform(M.transpose(-1, -2)).transpose(-1, -2)
        else:
            A = limb_matmul(self.meta, self.w1, M)
        with span("gf.ntt.twiddle", A):
            B = _multiply_chunked(self.ops, A, self.t)
        C = self.sub2.transform(B) if self.sub2 is not None else limb_matmul(self.meta, B, self.w2)
        return C.transpose(-1, -2).reshape(batch + (self.N,))


# Bounded: a 2^24 plan holds up to 1.5 GB of device tables (BLS12-381).
@functools.lru_cache(maxsize=16)
def _plan(meta: FieldMeta, N: int, omega_int: int, mode: str, device: torch.device):
    if meta.is_prime_field and meta.characteristic > 2 and (meta.storage == STORAGE_INT or _limb_supports(meta)):
        n1 = _matmul_split(N)
        if n1 is None and N > _MAX_BASE and max(int_factors(N)[0]) <= 4096:
            # no two-factor split <= 4096: a recursive 6-step plan serves any
            # 4096-smooth N, with the direct side as large as it can be
            n1 = _largest_divisor_le(N, 4096)
        if n1 is not None:
            return MatmulFFTPlan(meta, N, omega_int, mode, n1, device)
    return FFTPlan(meta, N, omega_int, mode, device)


def _get_omega(cls, N: int) -> int:
    meta = cls._meta
    q = meta.order
    if (q - 1) % N != 0:
        raise ValueError(
            f"The FFT size {N} must divide the multiplicative group order {q - 1} of {cls.name}."
        )
    return get_host_field(meta).power(meta.primitive_element_int, (q - 1) // N)


def fft_data(cls, data: torch.Tensor, N: int, inverse: bool = False, scale: bool = None):
    """Transform the trailing axis of a storage tensor on its device.
    ``scale`` defaults to False forward and True inverse (NumPy's norm)."""
    meta = cls._meta
    hf = get_host_field(meta)
    omega = _get_omega(cls, N)
    if scale is None:
        scale = inverse
    if inverse:
        omega = hf.reciprocal(omega)
    out = _plan(meta, N, omega, kernel_mode(cls), data.device).transform(data)
    return _divide_by_n(cls, out, N) if scale else out


def _divide_by_n(cls, out: torch.Tensor, N: int) -> torch.Tensor:
    """out * (1/N). N acts as the N-fold sum of 1, i.e. the prime-subfield
    element N mod p (not the integer representation N)."""
    meta = cls._meta
    n_inv = get_host_field(meta).reciprocal(N % meta.characteristic)
    with span("gf.ntt.twiddle", out):
        n_inv = _ints_to_storage(meta, np.array(n_inv, dtype=object), out.device)
        return _multiply_chunked(get_ops(meta, kernel_mode(cls)), out, n_inv)


def field_fft(x, n=None, axis=-1, norm=None):
    """np.fft.fft for FieldArrays over the trailing axis. norm follows
    NumPy: the forward transform scales by 1/N only for norm="forward"."""
    cls = type(x)
    if axis != -1:
        raise ValueError("Argument 'axis' must be -1 (trailing axis).")
    if norm not in (None, "backward", "forward"):
        raise ValueError("Argument 'norm' must be None, 'backward', or 'forward'.")
    N = x.shape[-1] if n is None else int(n)
    with span("gf.ntt", x._data):
        x = _pad_or_trim(x, N)
        return cls._view(fft_data(cls, x._data, N, scale=(norm == "forward")), x._dtype)


def field_ifft(x, n=None, axis=-1, norm=None):
    """Inverse transform; scales by 1/N unless norm="forward"."""
    cls = type(x)
    if axis != -1:
        raise ValueError("Argument 'axis' must be -1 (trailing axis).")
    if norm not in (None, "backward", "forward"):
        raise ValueError("Argument 'norm' must be None, 'backward', or 'forward'.")
    N = x.shape[-1] if n is None else int(n)
    with span("gf.ntt", x._data):
        x = _pad_or_trim(x, N)
        return cls._view(fft_data(cls, x._data, N, inverse=True, scale=(norm != "forward")), x._dtype)


def _pad_or_trim(x, N: int):
    cls = type(x)
    cur = x.shape[-1]
    if cur == N:
        return x
    if cur > N:
        return x[..., :N]
    pad = cls.Zeros(x.shape[:-1] + (N - cur,), device=x.device)
    return cls._view(torch.cat([x._data, pad._data], dim=-1), x._dtype)
