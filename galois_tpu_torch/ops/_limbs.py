"""Int64 arithmetic on planar 16-bit limbs.

The limb storage of GF(p), p > 2^32 (``fields/_meta.py``), keeps L
little-endian base-2^16 limbs per element with the limb axis leading,
shape (L, *shape). The helpers below work on that layout once the limbs
are widened to int64, and serve the field arrays (``fields/_array.py``),
``LimbPrimeOps`` (``ops/_kernels.py``), K10's plain version
(``ops/_elementwise.py``) and the selects and index ops of every field op
on storage (``_where``, ``_i16``). They import only torch.
"""

from __future__ import annotations

import torch

__all__ = ["align_planar", "normalize_limbs", "mul_limbs", "planar_power_words"]


def _i16(t):
    """uint16 limb storage as an int16 view, for the index ops and selects
    that torch lacks for uint16 (``index_copy_`` on the CPU, gathers on
    CUDA); other storage as it is."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _where(mask, x, y):
    """torch.where for storage tensors of one dtype, uint16 included."""
    return torch.where(mask, _i16(x), _i16(y)).view(x.dtype)


def align_planar(a: torch.Tensor, b: torch.Tensor):
    """Pad the element axes of the lower-rank planar (limbs-first) operand
    just after its limb axis, so that the element axes broadcast
    right-aligned."""
    nd = max(a.ndim, b.ndim)
    a = a.reshape(a.shape[:1] + (1,) * (nd - a.ndim) + a.shape[1:])
    b = b.reshape(b.shape[:1] + (1,) * (nd - b.ndim) + b.shape[1:])
    return a, b


def planar_power_words(a: torch.Tensor, words, nbits: int, multiply, square, one_like):
    """a**e on planar (L, *shape) storage for e = sum_i words[i] * 2^(62 i),
    non-negative int64 word tensors broadcast against a's elements, over
    the low ``nbits`` bits: a binary ladder of the field's ``multiply`` and
    ``square`` (0**0 = 1). ``_elementwise.power_ladder`` is its form for
    one-word storage."""
    eshape = torch.broadcast_shapes(a.shape[1:], *(w.shape for w in words))
    a = a.reshape(a.shape[:1] + (1,) * (len(eshape) - (a.ndim - 1)) + a.shape[1:])
    base = _i16(a).expand((a.shape[0],) + tuple(eshape)).view(a.dtype)
    result = one_like(base)
    for i in range(nbits):
        bit = ((words[i // 62] >> (i % 62)) & 1).bool().expand(eshape)
        result = _where(bit, multiply(result, base), result)
        if i + 1 < nbits:
            base = square(base)
    return result


def normalize_limbs(c: torch.Tensor):
    """Carry-propagate int64 limb columns c (K, ...) into 16-bit limbs;
    returns (limbs, carry out). Columns may be negative (``>>`` is
    arithmetic, so a borrow moves as a carry of -1)."""
    out = []
    carry = 0
    for k in range(c.shape[0]):
        t = c[k] + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack(out), carry


def mul_limbs(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of int64 limb tensors A (L, ...) and B (K, ...)
    with aligned element axes -> (L + K) normalized limbs. A column holds at
    most min(L, K) products below 2^32, far inside int64."""
    L, K = A.shape[0], B.shape[0]
    shape = torch.broadcast_shapes(A.shape[1:], B.shape[1:])
    C = torch.zeros((L + K,) + tuple(shape), dtype=torch.int64, device=A.device)
    for i in range(L):
        C[i : i + K] += A[i] * B
    return normalize_limbs(C)[0]
