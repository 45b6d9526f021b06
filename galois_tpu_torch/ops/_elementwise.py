"""Kernel K7: GF(2^m) elementwise multiply, m <= 16, in Triton.

Replaces ``gf2m_multiply_pallas`` (``galois_tpu/ops/_pallas/_elementwise.py:493``):
an m-step shift-AND-XOR carry-less product, then reduction by f from bit
2m - 2 down to bit m. It is the kernel behind ``BinaryExtOps.multiply`` for
int storage, so the headline GF(2^8) multiply runs on it.

What bounds it on the H100: the integer ALUs, not memory. A GF(2^8)
product moves 3 bytes but costs about 60 int32 shift/AND/XOR operations
(4 per ladder step, 4 per reduction step), so 2^24 products are about
1e9 operations, some 60 us at the card's int32 rate, against about 15 us
of HBM traffic (measured: 0.063 ms on an H100 80GB HBM3 at its 700 W
power limit). The design is one fused
pass: masked block loads of the storage dtype (uint8 or int64) straight
into int32 registers, the whole ladder in registers, one store. Packing
four GF(2^8) elements per word (the TPU's K8 SWAR kernel) is the known way
to cut the operation count. The TPU version's cast to u32 and padding to
(8, 1024) tiles are layout work for the TPU and are not carried over; the
ragged tail is masked.

Triton is imported inside the launching function, so this module imports
on machines without Triton; there the wrapper serves CPU tensors only.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["gf2m_multiply", "gf2m_multiply_plain"]

_BLOCK = 1024

# Bound to ``triton.language`` by ``_triton_kernel`` on first launch; the
# kernel below reads it as a module global when Triton compiles it.
tl = None


def _gf2m_multiply_kernel(a_ptr, b_ptr, o_ptr, n, M: "tl.constexpr", F: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    a = tl.load(a_ptr + offs, mask=mask, other=0).to(tl.int32)
    b = tl.load(b_ptr + offs, mask=mask, other=0).to(tl.int32)
    acc = tl.zeros([BLOCK], dtype=tl.int32)
    for i in tl.static_range(M):
        acc = acc ^ ((a << i) & (0 - ((b >> i) & 1)))
    for k in tl.static_range(M - 1):
        i = 2 * M - 2 - k
        acc = acc ^ ((0 - ((acc >> i) & 1)) & (F << (i - M)))
    tl.store(o_ptr + offs, acc.to(o_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_gf2m_multiply_kernel)


def gf2m_multiply_plain(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """The same ladder in torch, on any device. Inputs are widened to int32
    first: ``<<`` on uint8 would drop the carry-less product's high bits."""
    a, b = torch.broadcast_tensors(a, b)
    aw = a.to(torch.int32)
    bw = b.to(torch.int32)
    acc = torch.zeros_like(aw)
    for i in range(m):
        acc = acc ^ ((aw << i) & -((bw >> i) & 1))
    for i in range(2 * m - 2, m - 1, -1):
        acc = acc ^ (-((acc >> i) & 1) & (f_int << (i - m)))
    return acc.to(a.dtype)


def gf2m_multiply(a: torch.Tensor, b: torch.Tensor, m: int, f_int: int) -> torch.Tensor:
    """GF(2^m) product of two storage tensors (broadcast), m <= 16.

    CPU tensors take ``gf2m_multiply_plain``; CUDA tensors launch the
    Triton kernel (and count the launch in ``gf2m_multiply.launches``) or
    raise."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gf2m_multiply_plain(a, b, m, f_int)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"gf2m_multiply: operands on {a.device} and {b.device}; need one CUDA device.")
    if a.dtype != b.dtype or a.dtype not in (torch.uint8, torch.int64):
        raise TypeError(f"gf2m_multiply: storage dtypes {a.dtype}, {b.dtype}; need uint8 or int64.")
    if not 2 <= m <= 16 or f_int >> m != 1:
        raise ValueError(f"gf2m_multiply: needs 2 <= m <= 16 and a degree-m f, got m={m}, f={f_int}.")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel()
    if n >= 2**31 - _BLOCK:
        raise ValueError(f"gf2m_multiply: {n} elements exceed the kernel's int32 offsets.")
    if n:
        kernel = _triton_kernel()
        with torch.cuda.device(a.device):
            kernel[(-(-n // _BLOCK),)](a, b, out, n, M=m, F=f_int, BLOCK=_BLOCK, num_warps=4)
        gf2m_multiply.launches += 1
    return out


gf2m_multiply.launches = 0
