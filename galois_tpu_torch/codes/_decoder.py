"""Batched BCH / Reed-Solomon decoder.

Port of ``galois_tpu/codes/_decoder.py``, stage by stage and bit-exact (the
reference's per-codeword pipeline: src/galois/_codes/_bch.py:1336-1576).
Every stage is a fixed-shape, branch-free computation over a (B, n) batch of
codewords on their device; failures are masks, not early exits:

 1. syndromes S_l = r(alpha^(c+l))                  (B, n) @ W
 2. erasure locator Gamma(x) = prod (1 - Y_k x)     by evaluation-interpolation
 3. modified syndromes S' = Gamma * S mod x^(d-1)   conv_trunc
 4. Berlekamp-Massey on S' from offset u -> Lambda  d - 1 masked steps
 5. Lambda_total = Gamma * Lambda; 2v + u <= d - 1
 6. Chien search over i < design_n                  Lambda_total @ CH^T
 7. Omega' = Lambda * S' mod x^(d-1)
 8. the formal derivative of Lambda_total
 9. Forney: E_j = -Omega'(X_j^-1) / Lambda'(X_j^-1) * X_j^(1-c)
10. correction; n_errors = v, or -1 where decoding failed

The products with constant matrices (the syndromes' W, Gamma's Vinv_T,
Chien's CH_T, Forney's CHn_T twice) run for GF(2^m), 2 <= m <= 16, as one
launch each of kernel K15 (``ops/_gf2_linear.py``, ``csrc/gf2_linear.cu``):
each constant is expanded once per code into its GF(2)-linear map on the
host and copied once per device, and the product is the parities of the
received bits times that map on int8 tensor cores; a constant whose map
``_gf2_linear.supports`` refuses (past 64 MB) runs on bit planes
(``ops/_binary_matmul.py``), GF(p^m) on digit planes
(``ops/_digit_matmul.py``). Every other field product is ``ops.multiply``,
so GF(2^8) decoding launches K8 and GF(2^9) (BCH(511)) K7, and GF(2^m)
reciprocals and powers (Forney's, Gamma's) K8-A.
K8 reads its broadcast operands in place by stride: conv_trunc's (B, lb, la)
outer product, the derivative's (B, d - 1) times (1, d - 1) and Forney's
(B, n) times (1, n) launch on views, with no copy.
The scan (stage 4) is kernel K8-B for GF(2^m) inside
``ops/_bm_scan.py::bm_scan_supports`` (m <= 8 with d <= 65, 9 <= m <= 16
with d <= 33: RS(255,223) and BCH(511,493) among them), on any device (the
CPU runs its plain version), and elsewhere the plain loop of d - 1 batched
torch steps. The host constants W, CH, FP, Y, LT and Vinv_T, and K15's
maps, are built once per code and copied once to each device. Stages 1,
2-3, 4-5, 6 and 7-10 each run inside a span (``_tracing.py``:
``gf.decode.syndromes``, ``.erasure_locator``, ``.berlekamp_massey``,
``.chien``, ``.forney``), on only while a torch profiler runs.

Not carried over from the JAX package: ``jax.jit``, the memory-mapping
bound of its decoder cache, and the 7-bit int8 planes of the erasure log
table (an exact float64 product takes their place: the log sums stay below
n (q - 1) < 2^53).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tracing import span
from ..fields._hostfield import get_host_field
from ..fields._meta import STORAGE_INT, FieldMeta
from ..fields._tables import build_exp_log
from ..ops._binary_matmul import binary_matmul
from ..ops._binary_matmul import supports as bin_supports
from ..ops._bm_scan import berlekamp_massey_scan, berlekamp_massey_scan_plain, bm_scan_supports, tree_sum
from ..ops._digit_matmul import digit_matmul
from ..ops._digit_matmul import supports as dig_supports
from ..ops._gf2_linear import gf2_linear, linear_map, pack_map
from ..ops._gf2_linear import supports as linear_supports
from ..ops._kernels import get_ops

__all__ = ["make_decoder"]


@functools.lru_cache(maxsize=64)
def make_decoder(
    ext_meta: FieldMeta,
    mode: str,
    base_order: int,
    n: int,
    design_n: int,
    d: int,
    c: int,
    alpha_int: int,
    with_erasures: bool = True,
):
    """The batched decoder for received length n (<= design_n), with or
    without the erasure stages. It takes the (B, n) codeword storage
    (descending degrees, as users pass them) and, with erasures, a (B, n)
    bool tensor on the same device; it returns the corrected words in the
    syndrome field's storage and the int64 error counts, both on the device."""
    return _Decoder(ext_meta, mode, n, design_n, d, c, alpha_int, with_erasures)


class _Decoder:
    def __init__(self, meta, mode, n, design_n, d, c, alpha_int, with_erasures):
        if meta.storage != STORAGE_INT:
            raise NotImplementedError(f"FEC syndrome fields use int storage, not {meta.name}.")
        self.meta, self.ops = meta, get_ops(meta, mode)
        self.dt = meta.torch_dtype
        self.n, self.design_n, self.d = n, design_n, d
        self.nroots = d - 1
        self.with_erasures = with_erasures
        self._scan = (
            berlekamp_massey_scan
            if meta.characteristic == 2 and bm_scan_supports(meta.degree, d)
            else berlekamp_massey_scan_plain
        )
        hf = get_host_field(meta)

        # ---- host constants (int reprs) ----
        # Positions index the shortened received word in ascending degree:
        # position j <-> coefficient of x^j, locator Y_j = alpha^j.
        apow = [1] * max(design_n + 1, 2)
        for i in range(1, design_n + 1):
            apow[i] = hf.multiply(apow[i - 1], alpha_int)
        a_inv = hf.reciprocal(alpha_int)
        ainv_pow = [1] * (design_n + 1)
        for i in range(1, design_n + 1):
            ainv_pow[i] = hf.multiply(ainv_pow[i - 1], a_inv)

        # syndrome matrix W[j, l] = alpha^((c + l) j), j < n, l < d - 1
        W = np.zeros((n, self.nroots), dtype=np.int64)
        for j in range(n):
            base = hf.power(alpha_int, j)
            cur = hf.power(base, c)
            for l in range(self.nroots):
                W[j, l] = cur
                cur = hf.multiply(cur, base)

        # Chien matrix CH[i, j] = alpha^(-i j), i < design_n, j < d
        # (Lambda_total has degree <= d - 1)
        CH = np.zeros((design_n, d), dtype=np.int64)
        for i in range(design_n):
            cur = 1
            for j in range(d):
                CH[i, j] = cur
                cur = hf.multiply(cur, ainv_pow[i])

        # Forney position constants X_i^(1-c) = (alpha^-i)^(c-1), i < n
        FP = np.array([hf.power(ainv_pow[i], c - 1) for i in range(n)], dtype=np.int64)
        # the derivative's integer factors j mod p, j = 1 .. d - 1
        JMODP = np.arange(1, d) % meta.characteristic

        self.host = {"W": W, "CH_T": CH.T.copy(), "CHn_T": CH[:n, : self.nroots].T.copy(), "FP": FP, "JMODP": JMODP}

        if with_erasures:
            # Gamma(x) = prod over erased j of (1 - Y_j x) has degree <= d - 1,
            # so its values at d fixed points z_k determine it. Each value is a
            # product over the erased factors: a SUM of discrete logs, linear
            # in the erasure mask, so one (B, n) @ (n, d) product with the log
            # table LT gives every value; the coefficients come back through
            # the inverted Vandermonde matrix of the z_k.
            q = meta.order
            self.q, self.g_int = q, meta.primitive_element_int  # group generator (alpha may not be)
            _, LOG = build_exp_log(meta)
            zs = [0] + [apow[k] for k in range(d - 1)]  # d distinct points, z_0 = 0
            LT = np.zeros((n, d), dtype=np.int64)  # log_g(1 - Y_j z_k); 0 at zero factors
            zero_j = [-1] * d  # the position whose factor vanishes at z_k (at most one)
            for k in range(1, d):
                for j in range(n):
                    f = hf.subtract(1, hf.multiply(apow[j], zs[k]))
                    if f == 0:
                        zero_j[k] = j
                    else:
                        LT[j, k] = int(LOG[f])
            # Vandermonde V[k, t] = z_k^t and its exact inverse over the field
            V = [[hf.power(zs[k], t) for t in range(d)] for k in range(d)]
            M_ = [row[:] + [1 if i == j else 0 for j in range(d)] for i, row in enumerate(V)]
            for col in range(d):  # Gauss-Jordan on exact ints
                piv = next(r for r in range(col, d) if M_[r][col] != 0)
                M_[col], M_[piv] = M_[piv], M_[col]
                inv_p = hf.reciprocal(M_[col][col])
                M_[col] = [hf.multiply(v, inv_p) for v in M_[col]]
                for r in range(d):
                    if r != col and M_[r][col] != 0:
                        f = M_[r][col]
                        M_[r] = [hf.subtract(v, hf.multiply(f, w)) for v, w in zip(M_[r], M_[col])]
            # Vinv_T[k, t] = Vinv[t, k]: coefficients = values @ Vinv_T
            Vinv_T = np.array([[M_[r][d + cc] for cc in range(d)] for r in range(d)], dtype=np.int64).T
            self.host.update({"LT": LT.astype(np.float64), "Vinv_T": Vinv_T.copy()})
            self.zk = [k for k in range(1, d) if zero_j[k] >= 0]
            self.zj = [zero_j[k] for k in self.zk]
        # the constants' GF(2)-linear maps in K15's layout, keyed "T_<name>"
        self.maps = {
            f"T_{name}": pack_map(linear_map(meta, self.host[name]), meta.degree)
            for name in ("W", "Vinv_T", "CH_T", "CHn_T")
            if name in self.host and linear_supports(meta, *self.host[name].shape)
        }
        self._on = {}

    def consts(self, device):
        """The host constants on ``device`` (storage dtype; LT in float64;
        the maps in int8)."""
        if device not in self._on:
            on = {
                k: torch.from_numpy(v).to(device=device, dtype=torch.float64 if k == "LT" else self.dt)
                for k, v in self.host.items()
            }
            on.update({k: torch.from_numpy(v).to(device) for k, v in self.maps.items()})
            self._on[device] = on
        return self._on[device]

    # ---- batched field helpers ----

    def fmatmul(self, X, consts, name):
        """(B, K) @ consts[name], a (K, N) constant of the code: K15 by its
        map where it has one, else bit planes for GF(2^m), digit planes for
        GF(p^m), else a product and a tree of adds."""
        M = consts[name]
        if f"T_{name}" in consts:
            return gf2_linear(X, consts[f"T_{name}"], self.meta.degree, M.shape[1])
        K = X.shape[-1]
        if bin_supports(self.meta, K):
            return binary_matmul(self.meta, X, M)
        if dig_supports(self.meta, K):
            return digit_matmul(self.meta, X, M)
        return tree_sum(self.ops, self.ops.multiply(X[:, :, None], M[None, :, :]), 1)

    def conv_trunc(self, A, B, out_len: int):
        """Batched polynomial product (ascending coefficients) A (B, la) *
        B (B, lb), truncated or zero-padded to out_len coefficients: one field
        multiply builds the (B, lb, la) outer product, a pad-and-reshape shear
        moves row j to offset j (a right-zero-padded (lb, la + lb) block read
        with row stride la + lb - 1), and a tree of adds folds the rows."""
        la, lb = A.shape[1], B.shape[1]
        nb = A.shape[0]
        full = la + lb - 1
        P = self.ops.multiply(A[:, None, :], B[:, :, None])  # (B, lb, la)
        Ppad = torch.cat([P, torch.zeros((nb, lb, lb), dtype=P.dtype, device=P.device)], dim=2)
        sheared = Ppad.reshape(nb, lb * (la + lb))[:, : lb * full].reshape(nb, lb, full)
        out = tree_sum(self.ops, sheared, 1)
        if full > out_len:
            return out[:, :out_len]
        if full < out_len:
            return torch.cat([out, torch.zeros((nb, out_len - full), dtype=out.dtype, device=out.device)], dim=1)
        return out

    def berlekamp_massey(self, Sp, u):
        """The masked scan over the modified syndromes from the per-row
        offset u (the erasure count): (C, L), K8-B or its plain loop."""
        return self._scan(self.ops, Sp, u, self.d)

    # ---- the two specializations ----

    def __call__(self, received, erasures=None):
        if self.with_erasures:
            return self.decode_with_erasures(received, erasures)
        return self.decode_no_erasures(received)

    def decode_with_erasures(self, received, erasures):
        """received: (B, n) storage, DESCENDING degrees (as users pass them);
        erasures: (B, n) bool, same order."""
        ops, d, K = self.ops, self.d, self.consts(received.device)
        # 1. syndromes
        with span("gf.decode.syndromes", received):
            r = received.flip(1).to(self.dt)  # ascending degrees
            era = erasures.flip(1)
            u = era.sum(dim=1)  # erasure counts
            fail = u > self.nroots
            r_z = torch.where(era, torch.zeros_like(r), r)
            S = self.fmatmul(r_z, K, "W")  # (B, d - 1)

        with span("gf.decode.erasure_locator", received):
            # 2. Gamma by evaluation-interpolation: log Gamma(z_k) is linear in
            # the mask; the vanishing factors are patched to exact 0; the
            # inverted Vandermonde matrix gives the coefficients.
            logsum = torch.matmul(era.to(torch.float64), K["LT"]).to(torch.int64)  # exact: < n (q - 1)
            e_red = logsum % (self.q - 1)  # (B, d)
            g = torch.full((), self.g_int, dtype=self.dt, device=r.device)
            gvals = ops.power(g, e_red, nbits=(self.q - 1).bit_length())
            if self.zk:
                vanish = era[:, self.zj]
                gvals[:, self.zk] = torch.where(vanish, torch.zeros_like(vanish, dtype=self.dt), gvals[:, self.zk])
            gvals[:, 0] = 1  # Gamma(0) = 1
            gamma = self.fmatmul(gvals, K, "Vinv_T")  # (B, d) ascending coefficients
            # 3. modified syndromes
            Sp = self.conv_trunc(gamma, S, self.nroots)

        with span("gf.decode.berlekamp_massey", received):
            # 4. Berlekamp-Massey on S'[u:], starting at the per-row offset u
            C, v = self.berlekamp_massey(Sp, u)
            fail = fail | (2 * v + u > self.nroots)
            # 5. Lambda_total = Gamma * Lambda
            lam_total = self.conv_trunc(gamma, C, d)
        return self.finish(received, r_z, lam_total, Sp, C, v, u, fail)

    def decode_no_erasures(self, received):
        """Gamma = 1, S' = S, u = 0: no erasure locator, no Gamma products."""
        B = received.shape[0]
        with span("gf.decode.syndromes", received):
            r = received.flip(1).to(self.dt)
            S = self.fmatmul(r, self.consts(received.device), "W")
        with span("gf.decode.berlekamp_massey", received):
            u = torch.zeros(B, dtype=torch.int64, device=r.device)
            C, v = self.berlekamp_massey(S, u)
            fail = 2 * v > self.nroots
        return self.finish(received, r, C, S, C, v, u, fail)

    def finish(self, received, r_z, lam_total, Sp, C, v, u, fail):
        ops, n, K = self.ops, self.n, self.consts(received.device)
        with span("gf.decode.chien", received):
            # 6. Chien search over design_n positions
            root = self.fmatmul(lam_total, K, "CH_T") == 0  # (B, design_n)
            if self.design_n > n:
                fail = fail | root[:, n:].any(dim=1)
            root_n = root[:, :n]
            fail = fail | (root_n.sum(dim=1) != v + u)

        with span("gf.decode.forney", received):
            # 7. Omega' = Lambda * S' mod x^(d-1)
            omega = self.conv_trunc(C, Sp, self.nroots)
            # 8. derivative of Lambda_total: coefficient j - 1 gets (j mod p) lam_total[j]
            lam_prime = ops.multiply(lam_total[:, 1:], K["JMODP"][None, :])
            # 9. Forney at every position i < n, masked by root_n
            num = self.fmatmul(omega, K, "CHn_T")  # (B, n)
            den = self.fmatmul(lam_prime, K, "CHn_T")
            fail = fail | (root_n & (den == 0)).any(dim=1)
            E = ops.negative(ops.multiply(ops.multiply(num, ops.reciprocal(den)), K["FP"][None, :]))
            E = torch.where(root_n, E, torch.zeros_like(E))

            # 10. corrected = r_z - E (in the base field where decoding
            # succeeds), back in descending order
            corrected = ops.subtract(r_z, E).flip(1)
            ok = ~fail
            out = torch.where(ok[:, None], corrected, received.to(self.dt))
            return out, torch.where(ok, v, -1)
