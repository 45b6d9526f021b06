"""Plain Reed-Solomon and binary BCH codes over GF(2^m), in plain torch.

The yardstick that decides a decode cell's ``correct``. It builds the field
from the configuration's polynomial, the code's generator from its roots,
systematic codewords by polynomial division, and decodes with the textbook
errors-and-erasures decoder: syndromes by Horner's rule, the erasure
locator, Forney syndromes, Berlekamp-Massey, Chien's search and Forney's
formula. Field products are EXP[LOG a + LOG b] lookups on int64 tensors;
every polynomial is a (B, len) tensor of ascending coefficients, one row a
word. It runs on any device and imports nothing outside torch.

Word layout as the library's users pass words: index 0 holds the
coefficient of x^(n-1); the message is the first k symbols. Decoding
semantics: a word decodes when 2v + f <= d - 1 (v errors found, f erasures)
and its errata locator has exactly v + f roots among the n positions with a
nonzero derivative there; the result is then the corrected word and the
count v. Otherwise the result is the received word unchanged and the count
-1. A binary BCH word is corrected in GF(2^m) and then read back as its low
bit, as the library under test returns it.
"""

from __future__ import annotations

import torch

__all__ = ["GF2m", "CyclicCode", "code_from_config"]


class GF2m:
    """GF(2^m) with the primitive polynomial ``poly`` (bit i the coefficient
    of x^i): the element 2 (x) generates the multiplicative group."""

    def __init__(self, m: int, poly: int, device="cpu"):
        q = 1 << m
        exp, log = [0] * (2 * (q - 1)), [0] * q
        x = 1
        for i in range(q - 1):
            if i and x == 1:
                raise ValueError(f"{poly:#x} is not primitive over GF(2^{m})")
            exp[i], log[x] = x, i
            x <<= 1
            if x & q:
                x ^= poly
        if x != 1:
            raise ValueError(f"{poly:#x} is not primitive over GF(2^{m})")
        exp[q - 1 :] = exp[: q - 1]
        self.m, self.q, self.poly = m, q, poly
        self.exp_list, self.log_list = exp, log
        self.EXP = torch.tensor(exp, dtype=torch.int64, device=device)
        self.LOG = torch.tensor(log, dtype=torch.int64, device=device)
        self.device = torch.device(device)

    # host scalars
    def mul_int(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return self.exp_list[self.log_list[a] + self.log_list[b]]

    def pow_int(self, a: int, e: int) -> int:
        if a == 0:
            return 0 if e else 1
        return self.exp_list[(self.log_list[a] * e) % (self.q - 1)]

    # tensors of int64 elements
    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        prod = self.EXP[self.LOG[a] + self.LOG[b]]
        return torch.where((a == 0) | (b == 0), torch.zeros_like(prod), prod)

    def div(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a / b where b != 0 (0 where b == 0)."""
        quo = self.EXP[(self.LOG[a] - self.LOG[b]) % (self.q - 1)]
        return torch.where((a == 0) | (b == 0), torch.zeros_like(quo), quo)

    def powers(self, base: int, count: int) -> torch.Tensor:
        """base^0 .. base^(count-1) as a tensor."""
        return torch.tensor([self.pow_int(base, j) for j in range(count)], dtype=torch.int64, device=self.device)


def poly_mul_trunc(F: GF2m, a: torch.Tensor, b: torch.Tensor, length: int) -> torch.Tensor:
    """(a * b) mod x^length, rows of ascending coefficients."""
    out = torch.zeros((a.shape[0], length), dtype=torch.int64, device=a.device)
    for i in range(min(b.shape[1], length)):
        w = min(a.shape[1], length - i)
        out[:, i : i + w] ^= F.mul(a[:, :w], b[:, i : i + 1])
    return out


def poly_eval(F: GF2m, p: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """p (B, D) ascending at points (P,) by Horner's rule: (B, P)."""
    acc = torch.zeros((p.shape[0], points.shape[0]), dtype=torch.int64, device=p.device)
    for i in range(p.shape[1] - 1, -1, -1):
        acc = F.mul(acc, points[None, :]) ^ p[:, i : i + 1]
    return acc


def xor_reduce(F: GF2m, x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of x's elements along ``dim``: each bit is the parity of a sum."""
    bits = torch.arange(F.m, device=x.device)
    planes = (x.unsqueeze(-1) >> bits) & 1
    parity = planes.sum(dim=dim) & 1
    return (parity << bits).sum(dim=-1)


def syndromes_horner(F: GF2m, r_asc: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """S_l = r(roots_l) for ascending words r (B, n): (B, len(roots))."""
    acc = torch.zeros((r_asc.shape[0], roots.shape[0]), dtype=torch.int64, device=r_asc.device)
    for j in range(r_asc.shape[1] - 1, -1, -1):
        acc = F.mul(acc, roots[None, :]) ^ r_asc[:, j : j + 1]
    return acc


PRECISIONS = ("float32", "tfloat32", "bfloat16", "float8_e4m3fn")


def _plane_product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b of 0/1 float32 planes in ``precision``: float32; TF32 inputs
    (float32 accumulation) where the device has them; bfloat16 inputs and
    output; or float8_e4m3fn output, the exact sums rounded to that type as
    a product with fp8 outputs gives them."""
    if precision == "bfloat16":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tfloat32"
    try:
        sums = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    if precision == "float8_e4m3fn":
        return sums.to(torch.float8_e4m3fn).to(torch.float32)
    return sums


def syndromes_planes(F: GF2m, r_asc: torch.Tensor, roots: torch.Tensor, precision: str) -> torch.Tensor:
    """The same syndromes as one product with the matrix W[j, l] = roots_l^j
    on 0/1 bit planes, the parity of each plane product's sums taken in
    ``precision`` (one of PRECISIONS). A sum of 0/1 products is exact in
    float32 and TF32, in bfloat16 up to 256 and in float8_e4m3fn up to 16;
    past that its parity, and so the syndrome, can be wrong."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    m, n = F.m, r_asc.shape[1]
    W = torch.stack([F.powers(int(b), n) for b in roots.tolist()], dim=1).to(r_asc.device)  # (n, L)
    bits = torch.arange(m, device=r_asc.device)
    rp = ((r_asc.unsqueeze(0) >> bits[:, None, None]) & 1).to(torch.float32)  # (m, B, n)
    wp = ((W.unsqueeze(0) >> bits[:, None, None]) & 1).to(torch.float32)  # (m, n, L)
    prod_bits = [None] * (2 * m - 1)
    for a in range(m):
        for b in range(m):
            par = _plane_product(rp[a], wp[b], precision).to(torch.int64) & 1
            k = a + b
            prod_bits[k] = par if prod_bits[k] is None else prod_bits[k] ^ par
    # fold x^(m + k) back through the field polynomial
    out = torch.zeros_like(prod_bits[0])
    for k in range(2 * m - 1):
        if k < m:
            out ^= prod_bits[k] << k
        else:
            v = 1 << k
            for i in range(k, m - 1, -1):
                if (v >> i) & 1:
                    v ^= F.poly << (i - m)
            out ^= prod_bits[k] * v
    return out


class CyclicCode:
    """An (n, k) code over GF(2^m) or, with ``binary``, over GF(2) with its
    syndromes in GF(2^m), whose generator has the consecutive roots
    alpha^(c + l), l = 0 .. d - 2 (binary: with their conjugates)."""

    def __init__(self, F: GF2m, n: int, k: int, d: int, alpha: int, c: int, binary: bool):
        self.F, self.n, self.k, self.d = F, n, k, d
        self.alpha, self.c, self.binary = alpha, c, binary
        self.roots = torch.tensor([F.pow_int(alpha, c + l) for l in range(d - 1)], dtype=torch.int64, device=F.device)
        self.generator = self._generator()  # ascending, monic
        if len(self.generator) - 1 != n - k:
            raise ValueError(f"the generator has degree {len(self.generator) - 1}, not n - k = {n - k}")
        # X_j = alpha^j at the ascending position j, its inverse, and X_j^(1 - c)
        self.X = F.powers(alpha, n)
        a_inv = F.pow_int(alpha, F.q - 2)
        self.Xinv = F.powers(a_inv, n)
        self.X1c = torch.tensor([F.pow_int(F.pow_int(a_inv, j), c - 1) for j in range(n)], dtype=torch.int64, device=F.device)

    def _generator(self) -> list:
        F = self.F
        exps = {(self.c + l) for l in range(self.d - 1)}
        order = F.q - 1  # alpha is primitive for these codes
        if self.binary:
            closed = set()
            for e in exps:
                x = e % order
                while x not in closed:
                    closed.add(x)
                    x = 2 * x % order
            exps = closed
        g = [1]
        for e in sorted(exps):
            root = F.pow_int(self.alpha, e)
            nxt = [0] * (len(g) + 1)
            for i, gi in enumerate(g):  # g * (x + root)
                nxt[i + 1] ^= gi
                nxt[i] ^= F.mul_int(gi, root)
            g = nxt
        if self.binary and any(v > 1 for v in g):
            raise ValueError("the binary generator has a coefficient outside GF(2)")
        return g

    def encode(self, msg: torch.Tensor) -> torch.Tensor:
        """Systematic codewords (B, n) of messages (B, k), users' order:
        [m | parity], parity = m(x) x^(n-k) mod g(x)."""
        F, r = self.F, self.n - self.k
        g_desc = torch.tensor(self.generator[:-1][::-1], dtype=torch.int64, device=msg.device)  # g_(r-1) .. g_0
        reg = torch.zeros((msg.shape[0], r), dtype=torch.int64, device=msg.device)
        for i in range(self.k):
            fb = msg[:, i : i + 1] ^ reg[:, :1]
            reg = torch.cat([reg[:, 1:], torch.zeros_like(reg[:, :1])], dim=1) ^ F.mul(fb, g_desc[None, :])
        return torch.cat([msg, reg], dim=1)

    def decode(self, received: torch.Tensor, erasures: torch.Tensor = None, syndromes=None):
        """Decode (B, n) received words (users' order) with an optional (B, n)
        bool erasure mask: (words (B, n), counts (B,)), both int64.
        ``syndromes(F, r_asc, roots)`` replaces Horner's syndromes."""
        F, n, d = self.F, self.n, self.d
        nroots = d - 1
        B, dev = received.shape[0], received.device
        rec = received.to(torch.int64)
        r = rec.flip(1)  # ascending degree: r[:, j] is the coefficient of x^j
        if erasures is not None:
            era = erasures.flip(1)
            u = era.sum(dim=1)
            r_z = torch.where(era, torch.zeros_like(r), r)
        else:
            u = torch.zeros(B, dtype=torch.int64, device=dev)
            r_z = r
        S = (syndromes or syndromes_horner)(F, r_z, self.roots)  # (B, d - 1)

        gamma = torch.zeros((B, d), dtype=torch.int64, device=dev)
        gamma[:, 0] = 1
        if erasures is not None:  # Gamma(x) = prod over erased j of (1 + X_j x)
            for j in range(n):
                shifted = torch.cat([torch.zeros_like(gamma[:, :1]), gamma[:, :-1]], dim=1)
                step = gamma ^ F.mul(shifted, self.X[j].expand(B, 1))
                gamma = torch.where(era[:, j : j + 1], step, gamma)
            T = poly_mul_trunc(F, gamma, S, nroots)  # Forney syndromes
        else:
            T = S

        lam, L = self._berlekamp_massey(T, u)
        fail = (u > nroots) | (2 * L + u > nroots)
        psi = poly_mul_trunc(F, gamma, lam, d)  # the errata locator

        root = poly_eval(F, psi, self.Xinv) == 0  # (B, n)
        fail |= root.sum(dim=1) != L + u
        omega = poly_mul_trunc(F, S, psi, nroots)
        odd = (torch.arange(1, d, device=dev) % 2).to(torch.bool)
        dpsi = torch.where(odd[None, :], psi[:, 1:], torch.zeros_like(psi[:, 1:]))  # derivative, ascending
        num = poly_eval(F, omega, self.Xinv)
        den = poly_eval(F, dpsi, self.Xinv)
        fail |= (root & (den == 0)).any(dim=1)
        E = F.mul(F.div(num, den), self.X1c[None, :])
        E = torch.where(root, E, torch.zeros_like(E))
        corrected = r_z ^ E
        if self.binary:
            corrected = corrected & 1
        out = torch.where(fail[:, None], r, corrected).flip(1)
        return out, torch.where(fail, torch.full_like(L, -1), L)

    def _berlekamp_massey(self, T: torch.Tensor, u: torch.Tensor):
        """The shortest LFSR (C, L) of each row's sequence T[u:], batched:
        Massey's algorithm, a row's steps masked past its length."""
        F, d = self.F, self.d
        nroots = d - 1
        B, dev = T.shape[0], T.device
        ar = torch.arange(d, device=dev)
        C = torch.zeros((B, d), dtype=torch.int64, device=dev)
        C[:, 0] = 1
        P = C.clone()  # the connection polynomial before the last length change
        L = torch.zeros(B, dtype=torch.int64, device=dev)
        shift = torch.ones(B, dtype=torch.int64, device=dev)
        b = torch.ones(B, dtype=torch.int64, device=dev)
        length = nroots - u
        for step in range(nroots):
            active = step < length
            idx = u[:, None] + step - ar[None, :]
            valid = (ar <= step)[None, :] & (idx < nroots)
            Tg = T.gather(1, idx.clamp(0, nroots - 1))
            delta = xor_reduce(F, torch.where(valid, F.mul(C, Tg), torch.zeros_like(Tg)), dim=1)
            src = ar[None, :] - shift[:, None]
            Ps = torch.where(src >= 0, P.gather(1, src.clamp(min=0)), torch.zeros_like(P))
            C_new = C ^ F.mul(F.div(delta, b)[:, None], Ps)
            nz = active & (delta != 0)
            grow = nz & (2 * L <= step)
            P = torch.where(grow[:, None], C, P)
            b = torch.where(grow, delta, b)
            L = torch.where(grow, step + 1 - L, L)
            C = torch.where(nz[:, None], C_new, C)
            shift = torch.where(active, torch.where(grow, torch.ones_like(shift), shift + 1), shift)
        return C, L


def code_from_config(cfg: dict, device="cpu") -> CyclicCode:
    """The code a configuration file describes (keys ``n``, ``k``, ``d``, ``m``,
    ``field_poly``, ``alpha_exponent``, ``c``, ``symbols``)."""
    F = GF2m(cfg["m"], cfg["field_poly"], device)
    alpha = F.pow_int(2, cfg["alpha_exponent"])
    return CyclicCode(F, cfg["n"], cfg["k"], cfg["d"], alpha, cfg["c"], binary=cfg["symbols"] == "GF(2)")
