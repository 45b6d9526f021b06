#!/usr/bin/env python3
"""Time kernels K8-A (GF(2^m) reciprocal and powers) and K8 (GF(2^m <= 8)
multiply), and the decodes that run them, for the galois_tpu_torch package
found first on the path, on one CUDA card.

    PYTHONPATH=<tree> python3 scripts/power_timing.py [label]

K8-A: the reciprocal of GF(2^8) at 2^24 and at Forney's (65536, 255)
(uint8), an exponent tensor of 40 bits at 2^24, and the reciprocal on int64
storage of GF(2^16) at 2^24 and GF(2^9) at BCH(511,493)'s (16384, 511), with
torch.take of the q-entry reciprocal table on the same inputs beside the
int64 ones. K8 on GF(2^8): 2^24 contiguous, and the RS decoder's shapes
through the wrapper (a tree that materializes broadcast operands pays for
the copies in the call): the outer product (65536, 32, 33) of (65536, 1, 33)
and (65536, 32, 1), Forney's (65536, 255) times (1, 255) and times (65536,
255), and the derivative's (65536, 32) times (1, 32). Each case is checked
against the plain ladder or chain once, then timed by CUDA-graph replay
(the mean of one replay of `reps` calls). Then the RS(255,223) decode of
65536 words (0-16 errors), the same with erasures (2e + f <= 32) and the
BCH(511,493) decode of 16384 words (0-2 bit errors), timed eagerly by CUDA
events. One JSON line per case, the card's name and power limit first. Two
commits are compared in one call by running it with each tree's path in
turn.
"""

import json
import sys

import torch
from _timing import card, corrupt, eager_ms, graph_ms, ranks


def main() -> int:
    if not torch.cuda.is_available():
        print("power_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt
    from galois_tpu_torch.ops._elementwise import (
        gf2m_multiply_plain,
        gf2m_multiply_swar,
        gf2m_power,
        gf2m_power_plain,
    )

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    print(json.dumps({"label": label, "device": card(), "torch": torch.__version__, "package": gt.__file__}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(10)

    def emit(case, exact, ms, **extra):
        print(json.dumps({"label": label, "case": case, "exact": exact, "ms": ms, **extra}), flush=True)

    f8 = gt.GF(2**8)._meta.irreducible_poly_int
    a8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev).to(torch.uint8)
    b8 = torch.randint(0, 256, (2**24,), generator=gen, device=dev).to(torch.uint8)
    e8 = torch.randint(0, 2**40, (2**24,), generator=gen, device=dev)
    forney = a8[: 65536 * 255].reshape(65536, 255)
    for case, x, e, nb, reps in (
        ("K8-A reciprocal GF(2^8) 2^24 uint8", a8, None, 0, 20),
        ("K8-A reciprocal GF(2^8) Forney's (65536, 255) uint8", forney, None, 0, 20),
        ("K8-A exponent tensor GF(2^8) 2^24 (40 bits)", a8, e8, 40, 10),
    ):
        exact = bool(torch.equal(gf2m_power(x, e, 8, f8, nb), gf2m_power_plain(x, e, 8, f8, nb)))
        emit(case, exact, graph_ms(lambda: gf2m_power(x, e, 8, f8, nb), reps))
    del e8
    for m, shape in ((16, (2**24,)), (9, (16384, 511))):
        f = gt.GF(2**m)._meta.irreducible_poly_int
        x = torch.randint(0, 2**m, shape, generator=gen, device=dev)
        inv = gf2m_power_plain(torch.arange(2**m, device=dev), None, m, f)
        exact = bool(torch.equal(gf2m_power(x, None, m, f), torch.take(inv, x)))
        emit(f"K8-A reciprocal GF(2^{m}) {shape} int64", exact, graph_ms(lambda: gf2m_power(x, None, m, f), 20),
             take_ms=graph_ms(lambda: torch.take(inv, x), 20))
        del x
    torch.cuda.empty_cache()

    B = 65536
    cases = (
        ("K8 GF(2^8) 2^24 contiguous", a8, b8, 50),
        ("K8 outer product (65536, 32, 33) of (65536, 1, 33) x (65536, 32, 1)",
         a8[: B * 33].reshape(B, 1, 33), b8[: B * 32].reshape(B, 32, 1), 20),
        ("K8 Forney's (65536, 255) x (1, 255)", forney, b8[:255].reshape(1, 255), 20),
        ("K8 Forney's (65536, 255) x (65536, 255)", forney, b8[: B * 255].reshape(B, 255), 20),
        ("K8 derivative (65536, 32) x (1, 32)", a8[: B * 32].reshape(B, 32), b8[:32].reshape(1, 32), 50),
    )
    for case, x, y, reps in cases:
        exact = bool(torch.equal(gf2m_multiply_swar(x, y, 8, f8), gf2m_multiply_plain(x, y, 8, f8)))
        emit(case, exact, graph_ms(lambda: gf2m_multiply_swar(x, y, 8, f8), reps))
    del a8, b8, forney
    torch.cuda.empty_cache()

    rs, bch = gt.ReedSolomon(255, 223), gt.BCH(511, 493)
    for code, n_words, erasures in ((rs, 65536, False), (rs, 65536, True), (bch, 16384, False)):
        q = code.field.order
        msg = code.field.Random((n_words, code.k), generator=gen, device=dev)
        cw = code.encode(msg)
        rk = ranks(n_words, code.n, gen)
        if erasures:
            f_cnt = torch.randint(0, code.d, (n_words,), generator=gen, device=dev)
            counts = (torch.rand(n_words, generator=gen, device=dev) * ((code.d - 1 - f_cnt) // 2 + 1)).long()
            kw = {"erasures": rk < f_cnt[:, None]}
            hit = rk < (f_cnt + counts)[:, None]
        else:
            counts = torch.randint(0, code.t + 1, (n_words,), generator=gen, device=dev)
            kw, hit = {}, rk < counts[:, None]
        x = code.field._view(corrupt(cw._data, hit, q, gen))
        dec, nerr = code.decode(x, output="codeword", errors=True, **kw)
        exact = bool((dec._data[:, : code.k] == msg._data).all()) and bool((torch.as_tensor(nerr, device=dev) == counts).all())
        ms = eager_ms(lambda: code.decode(x, **kw), 5)
        name = type(code).__name__ + f"({code.n},{code.k}) decode" + (" with erasures" if erasures else "")
        emit(name, exact, ms, words=n_words, codewords_per_s=n_words / ms * 1e3)
        del msg, cw, x, dec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
