"""Exact matrix products over GF(p), p > 2^32, on planar limb storage.

Port of ``galois_tpu/ops/_limb_matmul.py``. Operands are planar (L, ...,
M, K) and (L, ..., K, N) base-2^16 limbs. Each is split into int8 digit
planes, every pair of planes is one exact int8 product with int32 sums,
the pair products are summed by diagonal s = i + j (the digit offset of
their product), and the diagonals are combined into the exact integer
product and reduced mod p:

- Goldilocks (p = 2^64 - 2^32 + 1): ten 7-bit planes, 100 pair products in
  19 diagonals, each below 2^31 for a block of K <= ``_MAX_BLOCK_K``; the
  combine folds with 2^64 = 2^32 - 1 (mod p).
- any other limb prime (BLS12-381's scalar field among them): 2L biased
  8-bit planes (byte - 128 in int8) with the rank-1 zero-point corrections
  added to each diagonal, blocks of K <= ``_kblk_for(2L)`` so that every
  diagonal's true sum stays below 2^32; the combine folds the limbs at and
  above 2L - 1 with 2^(16(2L-1)) mod p.

The generic path ends in the Barrett reduction of ``LimbPrimeOps._reduce``.
Goldilocks' combine is kernel K16 on CUDA (``goldilocks_combine``,
``csrc/gold_combine.cu``): each element's 19 diagonals times 2^(7s) mod p
summed in 128 bits and reduced in registers, the limbs written straight into
the product; its plain version, which CPU tensors take, is the generic
path's int64 limb columns, fold and Barrett. The plane products are
``int8_matmul``: ``torch._int_mm`` (int32 sums, as the MXU's) on CUDA, both
operands K-major, exact float64 products on the CPU. The K blocking is the
JAX package's; the output columns are processed in chunks whose
intermediates stay within ``_CHUNK_BYTES``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as tf

from .._tracing import span
from ._limbs import mul_limbs, normalize_limbs

__all__ = [
    "goldilocks_matmul", "generic_limb_matmul", "limb_matmul", "supports", "supports_any", "goldilocks_combine",
    "goldilocks_combine_plain",
]

GOLD_P = 2**64 - 2**32 + 1
_N_PLANES = 10  # ceil(64 / 7)
# the worst diagonal has 10 plane pairs; keep its sum < 2^31 exactly
_MAX_BLOCK_K = (2**31 - 1) // (127 * 127 * _N_PLANES)
_LIMB_BITS = 16
_DIGIT_BITS = 8
_GOLD_S = 2 * _N_PLANES - 1  # diagonals
# The largest value 19 nonnegative int32 diagonals stand for, and the limb
# columns that hold it: the plain combine's widths for any diagonals.
_GOLD_BOUND = (2**31 - 1) * sum(2 ** (7 * s) for s in range(_GOLD_S))
_GOLD_W = -(-(_GOLD_BOUND + GOLD_P).bit_length() // _LIMB_BITS)
# Memory budget of one output chunk's intermediates: the int32 diagonal
# sums, their int64 corrected and shifted copies, the limb columns and the
# Barrett products (``_bytes_per_column``); on Goldilocks' CUDA path, where
# K16 keeps nothing else, the diagonals and B's digit planes
# (``_gold_bytes_per_column``).
# At 4 GiB a BLS12-381 side of 4096 x 4096 runs in 12 chunks of 352 columns,
# whose long-K products run at about half the int8 peak (shorter chunks
# starve the card of tiles).
_CHUNK_BYTES = 2**32


def supports(meta) -> bool:
    return (
        meta.storage == "limbs"
        and meta.is_prime_field
        and meta.characteristic == GOLD_P
        and meta.storage_width == 4
    )


def supports_generic(meta) -> bool:
    return meta.storage == "limbs" and meta.is_prime_field


def supports_any(meta) -> bool:
    return supports(meta) or supports_generic(meta)


def _kblk_for(D: int) -> int:
    """K-block bound: true (unsigned-digit) diagonal sums must stay < 2^32;
    the worst diagonal has <= D pairs of byte products <= 255^2."""
    return min(2048, max(1, (2**32 - 1) // (255 * 255 * D)))


def _k_major(x: torch.Tensor) -> torch.Tensor:
    """x itself where cuBLASLt can read it in place (unit stride along K),
    else a contiguous copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def int8_matmul(a: torch.Tensor, bt: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """Exact int32 (a @ bt.T) of int8 matrices a (M, K) and bt (N, K) whose
    sums fit int32, into ``out`` if given: ``torch._int_mm`` on CUDA, both
    operands K-major (the layout cuBLASLt's int8 tensor-core kernels take;
    views with a row stride above K are read in place), every dimension
    zero padded to a multiple of 32 (``_int_mm`` needs M > 16 and K and N
    multiples of 8, and cuBLASLt refused an 8-deep K at M = 40); float64
    products on the CPU (exact below 2^53)."""
    if a.device.type == "cpu":
        c = torch.matmul(a.to(torch.float64), bt.to(torch.float64).T).to(torch.int32)
        return c if out is None else out.copy_(c)
    if a.device.type != "cuda":
        raise RuntimeError(f"int8_matmul serves CPU and CUDA tensors, not {a.device.type}.")
    (M, K), N = a.shape, bt.shape[0]
    Mp, Kp, Np = (-(-d // 32) * 32 for d in (M, K, N))
    if (Mp, Kp, Np) == (M, K, N):
        a, bt = _k_major(a), _k_major(bt)
        return torch._int_mm(a, bt.T) if out is None else torch._int_mm(a, bt.T, out=out)
    c = torch._int_mm(tf.pad(a, (0, Kp - K, 0, Mp - M)), tf.pad(bt, (0, Kp - K, 0, Np - N)).T)[:M, :N]
    return c if out is None else out.copy_(c)


def _digit_planes7(x: torch.Tensor) -> torch.Tensor:
    """(4, R, C) uint16 limbs of 64-bit values -> (10, R, C) int8 7-bit digits."""
    w = x.to(torch.int64)
    w = torch.cat([w, torch.zeros_like(w[:1])])
    out = []
    for i in range(_N_PLANES):
        k, r = divmod(7 * i, _LIMB_BITS)
        out.append((((w[k] | (w[k + 1] << _LIMB_BITS)) >> r) & 127).to(torch.int8))
    return torch.stack(out)


def _digit_planes8(x: torch.Tensor) -> torch.Tensor:
    """(L, R, C) uint16 limbs -> (2L, R, C) biased int8 byte planes: byte t
    is (limb[t // 2] >> 8 (t % 2)) & 255, stored as byte - 128."""
    w = x.to(torch.int32)
    planes = torch.stack([(w & 255) - 128, (w >> 8) - 128], dim=1)
    return planes.reshape((-1,) + tuple(x.shape[1:])).to(torch.int8)


def _limb_count(bound: int) -> int:
    return max(1, -(-bound.bit_length() // _LIMB_BITS))


def _fold_reduce(ops, X: torch.Tensor, bound: int, top: int) -> torch.Tensor:
    """X: normalized int64 limbs (W, ...) of a value below ``bound`` ->
    (L, ...) int64 limbs of X mod p. Limbs at and above ``top`` fold down
    with 2^(16 top) mod p until X fits the 2L limbs Barrett takes."""
    L, p = ops.L, ops.p
    X = X[: max(2 * L, _limb_count(bound))]  # the limbs above are zero
    c = pow(2, _LIMB_BITS * top, p)
    c_limbs = None
    while X.shape[0] > 2 * L:
        if c_limbs is None:
            vals = [(c >> (_LIMB_BITS * k)) & 0xFFFF for k in range(_limb_count(c))]
            c_limbs = torch.tensor(vals, dtype=torch.int64, device=X.device).reshape((-1,) + (1,) * (X.ndim - 1))
        bound = (2 ** (_LIMB_BITS * top) - 1) + (bound >> (_LIMB_BITS * top)) * c
        W = _limb_count(bound)
        prod = mul_limbs(X[top:], c_limbs)[:W]  # limbs past W are zero: the value is below bound
        S = torch.zeros((W,) + tuple(X.shape[1:]), dtype=torch.int64, device=X.device)
        S[:top] += X[:top]
        S[: prod.shape[0]] += prod
        X = normalize_limbs(S)[0]
    if X.shape[0] < 2 * L:
        X = torch.cat([X, X.new_zeros((2 * L - X.shape[0],) + tuple(X.shape[1:]))])
    return ops._reduce(X)


def _bytes_per_column(M: int, S: int, W: int, L: int) -> int:
    """Bytes of the intermediates per output column of ``_core``: S int32
    and 2 S int64 diagonal planes, 2 W int64 limb columns and about 8 L int64
    Barrett limbs, each of M rows."""
    return M * (4 * S + 16 * S + 16 * W + 64 * L)


def _gold_bytes_per_column(M: int, kb: int) -> int:
    """Bytes per output column of a chunk on Goldilocks' CUDA path: the 19
    int32 diagonal planes of M rows, and B's digit planes of a K block of kb
    rows at their widest (``_digit_planes7``'s int64 copy of the 4 limbs
    beside the 5-limb one and its zero row: 80 bytes a row, more than the
    int8 planes and ``b_rev`` that live beside the diagonals)."""
    return 4 * _GOLD_S * M + 80 * kb


def _chunk_columns(per_col: int) -> int:
    """Output columns of a chunk: the most multiples of 32 whose
    intermediates of ``per_col`` bytes a column fit ``_CHUNK_BYTES``, and
    32 at least (per_col is 0 at M = 0)."""
    return max(32, _CHUNK_BYTES // max(1, per_col) // 32 * 32)


def _check_combine(diag: torch.Tensor, out: torch.Tensor) -> None:
    if diag.dtype != torch.int32 or diag.ndim != 3 or diag.shape[0] != _GOLD_S:
        raise ValueError(
            f"goldilocks_combine: diag of shape {tuple(diag.shape)}, {diag.dtype}: need ({_GOLD_S}, rows, cols) int32."
        )
    if out.dtype != torch.uint16 or tuple(out.shape) != (4,) + tuple(diag.shape[1:]) or out.device != diag.device:
        raise ValueError(
            f"goldilocks_combine: out of shape {tuple(out.shape)}, {out.dtype} on {out.device} for diag of shape "
            f"{tuple(diag.shape)} on {diag.device}: need (4, rows, cols) uint16 on diag's device."
        )


def goldilocks_combine_plain(ops, diag: torch.Tensor, out: torch.Tensor, accumulate: bool = False) -> torch.Tensor:
    """K16's function in torch, on any device: the limb columns of
    sum_s diag[s] 2^(7s) (int64: each diagonal shifted into its column by
    ``index_add_``; with ``accumulate`` out's own residue added), carried,
    folded and reduced by Barrett (``ops``, Goldilocks' ``LimbPrimeOps``),
    stored into ``out`` (4, rows, cols) uint16. Exact for any nonnegative
    int32 diagonals."""
    _check_combine(diag, out)
    dev = diag.device
    s_t = torch.arange(_GOLD_S, device=dev)
    shift = (7 * s_t % _LIMB_BITS).reshape(_GOLD_S, 1, 1)
    col = 7 * s_t // _LIMB_BITS
    cols = torch.zeros((_GOLD_W,) + tuple(diag.shape[1:]), dtype=torch.int64, device=dev)
    cols.index_add_(0, col, diag.to(torch.int64) << shift)
    bound = _GOLD_BOUND
    if accumulate:
        cols[:4] += out.to(torch.int64)
        bound += GOLD_P - 1
    X = normalize_limbs(cols)[0]  # no carry out: W limbs hold the bound
    out.copy_(_fold_reduce(ops, X, bound, 4).to(torch.uint16))
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    from .._build import load

    lib = load("gold_combine")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gold_combine.argtypes = [vp, i64, i64, vp, i64, i64, i64, i32, i32, vp]
    lib.gold_combine.restype = ctypes.c_int
    return lib


def goldilocks_combine(ops, diag: torch.Tensor, out: torch.Tensor, accumulate: bool = False) -> torch.Tensor:
    """K16: out (4, rows, cols) uint16 = the limbs of sum_s diag[s] 2^(7s)
    mod p over Goldilocks, plus out's own residue with ``accumulate`` (a
    later K block); diag (19, rows, cols) int32 diagonal sums. ``out`` may be
    a view (the chunk's columns of the product) and is written in place.

    CPU tensors take ``goldilocks_combine_plain``; CUDA tensors launch the
    kernel (counted in ``goldilocks_combine.launches``) or raise. Both
    tensors are read at their strides; the inner one must be 1."""
    if diag.device.type == "cpu":
        return goldilocks_combine_plain(ops, diag, out, accumulate)
    if diag.device.type != "cuda":
        raise ValueError(f"goldilocks_combine: diag on {diag.device}; need a CUDA device or the CPU.")
    _check_combine(diag, out)
    rows, cols = diag.shape[1], diag.shape[2]
    if cols >= 2**31 or (cols > 1 and (diag.stride(2) != 1 or out.stride(2) != 1)):
        raise ValueError(
            f"goldilocks_combine: columns of diag (stride {diag.stride(2)}) and out (stride {out.stride(2)}) must "
            f"lie side by side, fewer than 2^31 ({cols})."
        )
    if rows and cols:
        with torch.cuda.device(diag.device):
            rc = _lib().gold_combine(
                diag.data_ptr(), diag.stride(0), diag.stride(1), out.data_ptr(), out.stride(0), out.stride(1),
                rows, cols, int(accumulate), ctypes.c_void_p(torch.cuda.current_stream(diag.device).cuda_stream),
            )
        if rc != 0:
            raise RuntimeError(f"goldilocks_combine: kernel launch failed with CUDA error {rc}.")
        goldilocks_combine.launches += 1
    return out


goldilocks_combine.launches = 0


def _diagonals(a_cat, b, blk, n0: int, n1: int, D: int, lo: list, hi: list, planes):
    """B's digit planes (D, kb, ncc) of the block's rows and columns n0..n1,
    and the block's 2D - 1 diagonal sums (S, M, ncc) int32, one int8 product
    each over the concatenated K of its pairs."""
    k0, kb, kp = blk
    M, ncc = a_cat.shape[0], n1 - n0
    bp = planes(b[:, k0 : k0 + kb, n0:n1])  # (D, kb, ncc)
    # digits D-1..0 side by side, each K-major: (ncc, D * kp)
    b_rev = tf.pad(bp.flip(0).transpose(1, 2), (0, kp - kb)).permute(1, 0, 2).reshape(ncc, D * kp)
    diag = torch.empty((2 * D - 1, M, ncc), dtype=torch.int32, device=a_cat.device)
    for s in range(2 * D - 1):
        j0 = D - 1 - s + lo[s]  # where digit s - lo[s] sits in b_rev
        int8_matmul(a_cat[:, lo[s] * kp : (hi[s] + 1) * kp],
                    b_rev[:, j0 * kp : (j0 + hi[s] - lo[s] + 1) * kp], out=diag[s])
    return bp, diag


def _core(ops, a: torch.Tensor, b: torch.Tensor, gold: bool) -> torch.Tensor:
    """Unbatched a (L, M, K) @ b (L, K, N) planar limbs -> (L, M, N) uint16.

    Each diagonal s is one int8 product over the concatenated K of its
    pairs: A's digits i_lo..i_hi side by side against B's digits s - i_lo
    down to s - i_hi, which B's planes stored in reverse digit order hold
    side by side too. Both are views of one K-major array each, so the
    2D - 1 products of a block read their operands in place and write
    their sums once. Goldilocks combines each block's sums with
    ``goldilocks_combine`` (K16 on CUDA), later blocks adding into the
    first's residues; the generic path adds every block into int64 limb
    columns and reduces once."""
    L = ops.L
    M, K, N = a.shape[1], a.shape[2], b.shape[2]
    dev = a.device
    if gold:
        D, kblk, planes = _N_PLANES, _MAX_BLOCK_K, _digit_planes7
    else:
        D, kblk, planes = 2 * L, _kblk_for(2 * L), _digit_planes8
    S = 2 * D - 1
    lo = [max(0, s - (D - 1)) for s in range(S)]
    hi = [min(D - 1, s) for s in range(S)]
    if gold:
        on_card = dev.type == "cuda"
        per_col = _gold_bytes_per_column(M, min(K, kblk)) if on_card else _bytes_per_column(M, S, _GOLD_W, L)
    else:
        s_t = torch.arange(S, device=dev)
        shift = (_DIGIT_BITS * s_t % _LIMB_BITS).reshape(S, 1, 1)
        col = _DIGIT_BITS * s_t // _LIMB_BITS
        i_lo, i_hi = torch.tensor(lo, device=dev), torch.tensor(hi, device=dev)
        npairs = (i_hi - i_lo + 1).reshape(S, 1, 1)
        # the exact integer product is below K (b^L - 1)^2, b = 2^16
        bound = K * (2 ** (_LIMB_BITS * L) - 1) ** 2
        W = max(_limb_count(bound), _DIGIT_BITS * (S - 1) // _LIMB_BITS + 3)
        per_col = _bytes_per_column(M, S, W, L)

    nc = _chunk_columns(per_col)
    blocks = []
    with span("gf.limb_matmul.products", a):
        for k0 in range(0, K, kblk):
            kb = min(kblk, K - k0)
            kp = -(-kb // 32) * 32  # zero digits on both sides add nothing, biased or not
            ap = tf.pad(planes(a[:, :, k0 : k0 + kb]), (0, kp - kb))  # (D, M, kp)
            cs = None
            if not gold:
                # prefix sums over the digits of A's row sums, for the corrections
                cs = torch.cat([torch.zeros_like(ap[:1, :, 0], dtype=torch.int64),
                                ap.sum(dim=2, dtype=torch.int64).cumsum(0)])
            blocks.append(((k0, kb, kp), ap.permute(1, 0, 2).reshape(M, D * kp), cs))

    out = torch.empty((L, M, N), dtype=torch.uint16, device=dev)
    if gold and not blocks:
        return out.zero_()  # K = 0: the empty sum, which no block writes
    for n0 in range(0, N, nc):
        n1 = min(N, n0 + nc)
        if gold:
            for i, (blk, a_cat, _) in enumerate(blocks):
                with span("gf.limb_matmul.products", a):
                    diag = _diagonals(a_cat, b, blk, n0, n1, D, lo, hi, planes)[1]
                with span("gf.limb_matmul.combine", a):
                    goldilocks_combine(ops, diag, out[:, :, n0:n1], accumulate=i > 0)
                del diag
            continue
        cols = torch.zeros((W, M, n1 - n0), dtype=torch.int64, device=dev)
        for blk, a_cat, cs in blocks:
            with span("gf.limb_matmul.products", a):
                bp, diag = _diagonals(a_cat, b, blk, n0, n1, D, lo, hi, planes)
            with span("gf.limb_matmul.combine", a):
                diag = diag.to(torch.int64)
                # true diagonal = P + 128 (colsum A' + rowsum B') + pairs * kb * 128^2
                rs = torch.cat([torch.zeros_like(bp[:1, 0], dtype=torch.int64),
                                bp.sum(dim=1, dtype=torch.int64).cumsum(0)])
                CS = cs[i_hi + 1] - cs[i_lo]  # (S, M)
                RS = rs[i_hi + 1] - rs[i_lo]  # (S, ncc)
                diag += (CS.unsqueeze(2) + RS.unsqueeze(1)) * 128 + npairs * (blk[1] * 16384)
                cols.index_add_(0, col, diag << shift)
                del diag
        with span("gf.limb_matmul.combine", a):
            X = normalize_limbs(cols)[0]  # no carry out: W limbs hold the bound
            del cols
            out[:, :, n0:n1] = _fold_reduce(ops, X, bound, 2 * L - 1).to(torch.uint16)
    return out


def _batched(core, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (L, ..., M, K) @ b (L, ..., K, N): batch axes after the limb axis
    broadcast; a batch on one side only folds into the product's M or N
    axis, so that it is one core call."""
    L, M, K, N = a.shape[0], a.shape[-2], a.shape[-1], b.shape[-1]
    nb_a, nb_b = a.ndim - 3, b.ndim - 3
    if nb_a <= 0 and nb_b <= 0:
        return core(a, b)
    if nb_a <= 0:
        # b batched: C[t] = a @ b[t], b's batch concatenated along N
        bt = b[0, ..., 0, 0].numel()
        b2 = b.reshape(L, bt, K, N).permute(0, 2, 1, 3).reshape(L, K, bt * N)
        out = core(a, b2).reshape(L, M, bt, N).permute(0, 2, 1, 3)
        return out.reshape(b.shape[:-2] + (M, N))
    if nb_b <= 0:
        # a batched: C[t] = a[t] @ b, a's batch stacked along M
        at = a[0, ..., 0, 0].numel()
        return core(a.reshape(L, at * M, K), b).reshape(a.shape[:-1] + (N,))
    bshape = torch.broadcast_shapes(a.shape[1:-2], b.shape[1:-2])
    a2 = a.reshape(a.shape[:1] + (1,) * (len(bshape) - nb_a) + a.shape[1:]).expand((L,) + bshape + (M, K))
    b2 = b.reshape(b.shape[:1] + (1,) * (len(bshape) - nb_b) + b.shape[1:]).expand((L,) + bshape + (K, N))
    a2, b2 = a2.reshape(L, -1, M, K), b2.reshape(L, -1, K, N)
    out = torch.stack([core(a2[:, t], b2[:, t]) for t in range(a2.shape[1])], dim=1)
    return out.reshape((L,) + bshape + (M, N))


def goldilocks_matmul(meta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (4, ..., M, K) @ b (4, ..., K, N) over Goldilocks, planar uint16
    limbs -> (4, ..., M, N)."""
    from ._kernels import get_ops

    ops = get_ops(meta, "jit-calculate")
    return _batched(lambda x, y: _core(ops, x, y, gold=True), a, b)


def generic_limb_matmul(meta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (L, ..., M, K) @ b (L, ..., K, N), planar uint16 limbs of a large
    prime field -> (L, ..., M, N), exact mod p."""
    from ._kernels import get_ops

    ops = get_ops(meta, "jit-calculate")
    return _batched(lambda x, y: _core(ops, x, y, gold=False), a, b)


def limb_matmul(meta, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Goldilocks' 7-bit path where it applies, else the generic byte path."""
    if supports(meta):
        return goldilocks_matmul(meta, a, b)
    return generic_limb_matmul(meta, a, b)
