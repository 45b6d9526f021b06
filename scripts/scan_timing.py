#!/usr/bin/env python3
"""Time kernel K8-B (the batched Berlekamp-Massey scan) and the decodes
that run it, for the galois_tpu_torch package found first on the path, on
one CUDA card.

    PYTHONPATH=<tree> python3 scripts/scan_timing.py [label]

Cases: RS(255,223)'s scan shape (65536, 32) over GF(2^8) with u = 0 and
with random u, d = 65 (65536, 64), BCH(511,493)'s (16384, 4) over GF(2^9)
and GF(2^12) at (65536, 32), each checked against the plain scan once and
then timed by CUDA-graph replay (the mean of one replay of `reps`
launches). Where the tree's K8-B does not take the field, the case times
the plain loop.
Then the public decodes of main path 4, RS(255,223) of 65536 words (0-16
errors) and BCH(511,493) of 16384 words (0-2 bit errors), timed eagerly by
CUDA events. One JSON line per case, the card's name and power limit first.
Two commits are compared in one call by running it with each tree's path in
turn.
"""

import json
import sys

import torch
from _timing import card, corrupt, eager_ms, graph_ms, ranks


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt
    from galois_tpu_torch.ops import _bm_scan
    from galois_tpu_torch.ops._kernels import get_ops

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    smi = card()
    print(json.dumps({"label": label, "device": smi, "torch": torch.__version__, "package": gt.__file__}), flush=True)
    scan, plain = _bm_scan.berlekamp_massey_scan, _bm_scan.berlekamp_massey_scan_plain

    gen = torch.Generator(device=dev).manual_seed(9)
    for m, d, rows, reps in ((8, 33, 65536, 20), (8, 65, 65536, 10), (9, 5, 16384, 50), (12, 33, 65536, 10)):
        F = gt.GF(2**m)
        ops = get_ops(F._meta, "jit-calculate")
        S = torch.randint(0, 2**m, (rows, d - 1), generator=gen, device=dev).to(F._meta.torch_dtype)
        S[1::97] = 0
        u_r = torch.randint(0, d + 3, (rows,), generator=gen, device=dev)
        u_0 = torch.zeros(rows, dtype=torch.int64, device=dev)
        kernel = _bm_scan.bm_scan_supports(m, d)
        for tag, u in (("u = 0", u_0), ("random u", u_r)) if m == 8 and d == 33 else (("u = 0", u_0),):
            Cp, Lp = plain(ops, S, u, d)
            row = {"label": label, "m": m, "d": d, "rows": rows, "u": tag}
            if kernel:
                C, L = scan(ops, S, u, d)
                torch.cuda.synchronize()
                row["exact"] = bool(torch.equal(C, Cp) and torch.equal(L, Lp))
                row["kernel_ms"] = graph_ms(lambda: scan(ops, S, u, d), reps)
            row["plain_ms"] = eager_ms(lambda: plain(ops, S, u, d), 3)
            print(json.dumps(row), flush=True)

    for code, B in ((gt.ReedSolomon(255, 223), 65536), (gt.BCH(511, 493), 16384)):
        q = code.field.order
        msg = code.field.Random((B, code.k), generator=gen, device=dev)
        cw = code.encode(msg)
        counts = torch.randint(0, code.t + 1, (B,), generator=gen, device=dev)
        x = code.field._view(corrupt(cw._data, ranks(B, code.n, gen) < counts[:, None], q, gen))
        launches = scan.launches
        dec, nerr = code.decode(x, output="codeword", errors=True)
        torch.cuda.synchronize()
        launched = scan.launches - launches
        exact = bool((dec._data[:, : code.k] == msg._data).all()) and bool((torch.as_tensor(nerr, device=dev) == counts).all())
        ms = eager_ms(lambda: code.decode(x), 5)
        print(json.dumps({
            "label": label, "decode": type(code).__name__ + f"({code.n},{code.k})", "B": B, "exact": exact,
            "scan_launches": launched, "ms": ms, "codewords_per_s": B / ms * 1e3,
        }), flush=True)
        del msg, cw, x, dec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
