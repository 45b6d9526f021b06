"""Kernel K8-B: the batched decoder's masked Berlekamp-Massey scan in one
launch (CUDA C++ in ``csrc/gf2m_chain.cu``; its head gives the design and
what bounds it on the H100).

``berlekamp_massey_scan_plain`` is the decoder's scan as a loop of d - 1
batched torch steps over any field's ops; it follows the jitted ``lax.scan``
``berlekamp_massey`` of ``galois_tpu/codes/_decoder.py`` step for step.
``berlekamp_massey_scan`` is the kernel's wrapper: CPU tensors take the plain
version, CUDA tensors launch the kernel (counted in
``berlekamp_massey_scan.launches``) or raise. The kernel covers GF(2^m) with
2 <= m <= 8 and d - 1 <= 64, and 9 <= m <= 16 with d - 1 <= 32
(``bm_scan_supports``); it reads the field's EXP and LOG in ``pack_tables``'
layout (``ops.packed_tables``). The decoder keeps the plain scan outside
that domain, on every device.
"""

from __future__ import annotations

import ctypes

import torch

from ._elementwise import _chain_lib

__all__ = ["bm_scan_supports", "berlekamp_massey_scan", "berlekamp_massey_scan_plain", "tree_sum"]

MAX_D = 65  # m <= 8: d - 1 <= 64 syndromes, C and B in at most 17 words of four bytes
MAX_D_WIDE = 33  # 9 <= m <= 16: one element a lane, C, B and the window in at most 3 x 33 registers


def bm_scan_supports(m: int, d: int) -> bool:
    """Whether K8-B takes a code of design distance d over GF(2^m)."""
    return 2 <= m <= 16 and 2 <= d <= (MAX_D if m <= 8 else MAX_D_WIDE)


def tree_sum(ops, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum along ``axis`` by a tree of pairwise adds."""
    size = x.shape[axis]
    while size > 1:
        half = size // 2
        pair = ops.add(x.narrow(axis, 0, half), x.narrow(axis, half, half))
        x = torch.cat([pair, x.narrow(axis, 2 * half, size - 2 * half)], dim=axis)
        size = x.shape[axis]
    return x.squeeze(axis)


def berlekamp_massey_scan_plain(ops, Sp: torch.Tensor, u: torch.Tensor, d: int):
    """Masked Berlekamp-Massey over the modified syndromes Sp (B, d - 1),
    from the per-row offset u (the erasure count): step t is a no-op while
    t < u, and relative step indices are t - u. The window of step t is
    Z[:, t + 1 : t + 1 + d] of the zero-padded Z = [0 (d) | S']. Returns the
    connection polynomials C (B, d), ascending, and their lengths L (B,)."""
    B, dev, dt = Sp.shape[0], Sp.device, Sp.dtype
    C = torch.zeros((B, d), dtype=dt, device=dev)
    C[:, 0] = 1
    Bp = C.clone()
    L = torch.zeros(B, dtype=torch.int64, device=dev)
    bb = torch.ones(B, dtype=dt, device=dev)
    Z = torch.cat([torch.zeros((B, d), dtype=dt, device=dev), Sp], dim=1)
    zero_col = torch.zeros((B, 1), dtype=dt, device=dev)
    for t in range(d - 1):
        active = t >= u  # rows with more erasures start later
        delta = tree_sum(ops, ops.multiply(C.flip(1), Z[:, t + 1 : t + 1 + d]), 1)
        Bp_shift = torch.cat([zero_col, Bp[:, :-1]], dim=1)  # x * B
        coef = ops.multiply(delta, ops.reciprocal(bb))
        C_new = ops.subtract(C, ops.multiply(Bp_shift, coef[:, None]))
        upd = active & (delta != 0)
        grow = upd & (2 * L <= t - u)
        # inactive rows (t < u) must not pre-shift their B register
        Bp = torch.where(active[:, None], torch.where(grow[:, None], C, Bp_shift), Bp)
        bb = torch.where(grow, delta, bb)
        L = torch.where(grow, t - u + 1 - L, L)
        C = torch.where(upd[:, None], C_new, C)
    return C, L


def berlekamp_massey_scan(ops, Sp: torch.Tensor, u: torch.Tensor, d: int):
    """K8-B: ``berlekamp_massey_scan_plain``'s (C, L) for a field GF(2^m)
    inside ``bm_scan_supports``; Sp (B, d - 1) in the field's storage (uint8
    for m <= 8, int64 above) and u (B,) int64 on one device."""
    if Sp.device.type == "cpu" and u.device.type == "cpu":
        return berlekamp_massey_scan_plain(ops, Sp, u, d)
    if Sp.device.type != "cuda" or u.device != Sp.device:
        raise ValueError(f"berlekamp_massey_scan: operands on {Sp.device} and {u.device}; need one CUDA device.")
    meta = ops.meta
    m = meta.degree
    if meta.characteristic != 2 or not bm_scan_supports(m, d):
        raise ValueError(
            f"berlekamp_massey_scan: needs GF(2^m) with 2 <= m <= 8 and 2 <= d <= {MAX_D}, or 9 <= m <= 16 and "
            f"2 <= d <= {MAX_D_WIDE}; got {meta.name}, d={d}."
        )
    B = Sp.shape[0]
    dt = torch.uint8 if m <= 8 else torch.int64
    if Sp.dtype != dt or u.dtype != torch.int64:
        raise TypeError(f"berlekamp_massey_scan: Sp of {Sp.dtype} and u of {u.dtype}; need {dt} and int64.")
    if Sp.shape != (B, d - 1) or u.shape != (B,):
        raise ValueError(f"berlekamp_massey_scan: Sp {tuple(Sp.shape)} and u {tuple(u.shape)}; need ({B}, {d - 1}) and ({B},).")
    Sp, u = Sp.contiguous(), u.contiguous()
    C = torch.empty((B, d), dtype=dt, device=Sp.device)
    L = torch.empty(B, dtype=torch.int64, device=Sp.device)
    if B:
        tables = ops.packed_tables(Sp.device)
        with torch.cuda.device(Sp.device):
            rc = _chain_lib().bm_scan_launch(
                Sp.data_ptr(), u.data_ptr(), tables.data_ptr(), C.data_ptr(), L.data_ptr(), B, d, m,
                meta.irreducible_poly_int, ctypes.c_void_p(torch.cuda.current_stream(Sp.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"berlekamp_massey_scan: kernel launch failed with CUDA error {rc}.")
        berlekamp_massey_scan.launches += 1
    return C, L


berlekamp_massey_scan.launches = 0
