"""Number-theoretic transform / finite-field FFT.

Port of ``galois_tpu/ops/_ntt.py``. ``_plan`` picks, per (field, N, omega,
device):

- ``MatmulFFTPlan`` for prime fields whose N splits into two factors
  <= 4096: the 4-step NTT as two exact modular matmuls around a twiddle
  multiply. Where the side kernels' gate holds (``_plane_matmul.supports``),
  side 1 is kernel K1 with the twiddle fused in and side 2 is kernel K2
  with a transposed store, as on the TPU; otherwise both sides are the
  plain plane matmul of ``_linalg.py``.
- ``FFTPlan``, the direct-DFT and mixed-radix Cooley-Tukey path, for
  N <= 64, non-prime fields and N without such a split.

Plans hold their tables as tensors on the device they were built for.
Host tables are built with vectorized NumPy uint64 modular arithmetic
(residues < 2^32, so products < 2^64). Recursive 6-step sub-plans
(N > 2^24) and the limb-storage branch are still to be ported; limb
fields raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..fields._array import _ints_to_storage
from ..fields._hostfield import get_host_field
from ..fields._meta import FieldMeta
from ..nt import factors as int_factors
from ._kernels import get_ops, mulmod
from ._linalg import _prime_matmul, balanced_planes_np
from ._plane_matmul import kmajor_planes, plane_matmul_data_left, plane_matmul_data_right, supports

__all__ = ["fft_data", "field_fft", "field_ifft", "FFTPlan", "MatmulFFTPlan"]

_MAX_BASE = 64  # transforms at or below this size use a direct DFT


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
    """[g^0, g^1, ..., g^(n-1)] as int64 int reprs.

    Prime fields double the filled prefix with NumPy uint64 products
    (both factors < p <= 2^32); GF(2^m) steps with exact host arithmetic."""
    if meta.is_prime_field:
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
    out = np.empty(n, dtype=np.int64)
    cur = 1
    for k in range(n):
        out[k] = cur
        cur = hf.multiply(cur, g)
    return out


class FFTPlan:
    """Precomputed tables for a size-N field FFT over GF(q) (N | q-1):
    mixed-radix recursion with direct-DFT contractions of radix <= 64."""

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
            prod = ops.multiply(x[..., j0 : j0 + chunk].unsqueeze(-2), W[:, j0 : j0 + chunk])
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
            Wj = W[:, j0 : j0 + chunk].unsqueeze(-2)  # (r, 1, c)
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


class MatmulFFTPlan:
    """Single-device 4-step NTT for int-storage prime fields.

    X[k1 + N1*k2] = sum_{n2} W2[n2,k2] * ( T[k1,n2] * sum_{n1} W1[k1,n1] *
    M[n1,n2] ) with M[n1,n2] = x[n1*N2 + n2]: two exact modular matmuls on
    balanced int8 planes (the W tables' planes are precomputed) around one
    elementwise twiddle.

    ``W1``, ``T`` and ``W2`` are the host tables in the JAX package's layout
    and dtype (``meta.internal_dtype``); ``load_tables`` installs a set of
    them as this plan's device tensors.
    """

    def __init__(self, meta: FieldMeta, N: int, omega_int: int, mode: str, n1: int, device):
        self.meta = meta
        self.N = N
        self.n1 = n1
        self.n2 = N // n1
        self.ops = get_ops(meta, mode)
        self.device = torch.device(device)
        hf = get_host_field(meta)
        if hf.power(omega_int, N) != 1:
            raise ValueError("omega must be an N-th root of unity.")
        p, n2 = meta.characteristic, self.n2
        # W1[k, j] = omega^(n2*k*j mod N) = (omega^n2)^(k*j mod n1); likewise
        # W2 with omega^n1. T[k, j] = omega^(k*j), k*j = q*n2 + r, is
        # (omega^n2)^q * omega^r: every table gathers from ladders of
        # length <= 4096 instead of a length-N power table.
        lad_hi = _power_ladder(meta, hf.power(omega_int, n2), n1).astype(np.uint64)
        lad_lo = _power_ladder(meta, omega_int, n2).astype(np.uint64)
        lad_w2 = _power_ladder(meta, hf.power(omega_int, n1), n2)
        k1 = np.arange(n1, dtype=np.int64)
        k2 = np.arange(n2, dtype=np.int64)
        kj = k1[:, None] * k2[None, :]
        T = lad_hi[kj // n2] * lad_lo[kj % n2] % np.uint64(p)
        self.load_tables(
            lad_hi[(k1[:, None] * k1[None, :]) % n1], T, lad_w2[(k2[:, None] * k2[None, :]) % n2]
        )

    def load_tables(self, W1: np.ndarray, T: np.ndarray, W2: np.ndarray) -> None:
        """Install host tables (e.g. ``plan.W1, plan.T, plan.W2`` of the JAX
        package's plan for the same field, N and omega) as this plan's
        device tensors: W1 and W2 as their balanced int8 planes, T as int64."""
        n1, n2, p = self.n1, self.n2, self.meta.characteristic
        W1, T, W2 = (np.asarray(t).astype(self.meta.internal_dtype) for t in (W1, T, W2))
        if W1.shape != (n1, n1) or T.shape != (n1, n2) or W2.shape != (n2, n2):
            raise ValueError(
                f"Tables of shapes {W1.shape}, {T.shape}, {W2.shape} do not fit a "
                f"{n1} x {n2} plan."
            )
        self.W1, self.T, self.W2 = W1, T, W2
        self.w1_planes = torch.from_numpy(balanced_planes_np(W1, p)).to(self.device)
        self.w2_planes = torch.from_numpy(balanced_planes_np(W2, p)).to(self.device)
        self.t = torch.from_numpy(T.astype(np.int64)).to(self.device)
        self.kernel_sides = supports(p, n1, n1, n2) and supports(p, n1, n2, n2)
        if self.kernel_sides:
            # the layout the kernels read: W1 (n, k1, n1) and W2 (n, k2, n2), K padded to 16
            self.w1_planes = kmajor_planes(self.w1_planes, 2)
            self.w2_planes = kmajor_planes(self.w2_planes, 1)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Transform the trailing axis of a storage tensor."""
        p = self.meta.characteristic
        batch = x.shape[:-1]
        M = x.reshape(batch + (self.n1, self.n2)).to(torch.int64)
        if self.kernel_sides:
            # Side 1 fuses the twiddle into its epilogue; side 2 stores its
            # tiles transposed, so the final (k1, k2) -> (k2, k1) swap is free.
            A = plane_matmul_data_right(self.w1_planes, M, p, twiddle=self.t)
            X = plane_matmul_data_left(A, self.w2_planes, p, transpose_out=True)
        else:
            A = _prime_matmul(None, M, p, self.n1, a_planes=self.w1_planes)
            C = _prime_matmul(mulmod(A, self.t, p), None, p, self.n2, b_planes=self.w2_planes)
            X = C.transpose(-1, -2)
        return X.reshape(batch + (self.N,)).to(self.meta.torch_dtype)


# Bounded: a 2^24 plan holds about 256 MB of device tables.
@functools.lru_cache(maxsize=16)
def _plan(meta: FieldMeta, N: int, omega_int: int, mode: str, device: torch.device):
    if meta.is_prime_field and meta.characteristic > 2:
        n1 = _matmul_split(N)
        if n1 is None and N > _MAX_BASE and max(int_factors(N)[0]) <= 4096:
            raise NotImplementedError(
                f"N = {N} needs a recursive 6-step plan, which the torch port does not have "
                "yet (ROADMAP.md, queue 1 item 3)."
            )
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
    if meta.storage_first:
        raise NotImplementedError(
            f"The NTT over {meta.name} needs the limb branch of MatmulFFTPlan (ops/_limb_matmul.py), "
            "which the torch port does not have yet (ROADMAP.md, queue 1 item 7)."
        )
    hf = get_host_field(meta)
    omega = _get_omega(cls, N)
    if scale is None:
        scale = inverse
    if inverse:
        omega = hf.reciprocal(omega)
    out = _plan(meta, N, omega, cls._mode, data.device).transform(data)
    if scale:
        # Scaling by 1/N: N acts as the N-fold sum of 1, i.e. the prime-
        # subfield element N mod p (not the integer representation N).
        n_inv = hf.reciprocal(N % meta.characteristic)
        ops = get_ops(meta, cls._mode)
        out = ops.multiply(out, torch.tensor(n_inv, dtype=meta.torch_dtype, device=out.device))
    return out


def field_fft(x, n=None, axis=-1, norm=None):
    """np.fft.fft for FieldArrays over the trailing axis. norm follows
    NumPy: the forward transform scales by 1/N only for norm="forward"."""
    cls = type(x)
    if axis != -1:
        raise ValueError("Argument 'axis' must be -1 (trailing axis).")
    if norm not in (None, "backward", "forward"):
        raise ValueError("Argument 'norm' must be None, 'backward', or 'forward'.")
    N = x.shape[-1] if n is None else int(n)
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
