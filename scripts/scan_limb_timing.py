#!/usr/bin/env python3
"""Time kernels K12-K14 and main path 8's calls of them for the
galois_tpu_torch package found first on the path, on one CUDA card, so that
two commits can be compared in one call by running it with each tree's path
in turn (parent, change, change, parent).

    PYTHONPATH=<tree> python3 scripts/scan_limb_timing.py [label] [--k12-only | --k13-only]

K14 by CUDA-graph replay: the GF(2^128) product (GCM's f) at 2^24 elements,
its reciprocal at 2^22 and its power by 63-bit exponent words at 2^24; then, through the public API at main path 8's
shapes and seeds (CUDA events around one eager call after a warm-up):
GF(2^128) x * y, np.reciprocal, x / y, x ** e (an int64 exponent array) and
np.sqrt at 2^24, GF(2^233) (B-233's f) np.reciprocal at 2^22. K12 by CUDA
events around eager calls: 2^14 ticks of the GF(2) degree-20 register (its
us a tick), the FLFSR's step(2^20) and step(-(2^20 - 1)), the GF(2^8) GLFSR
of RS(255,223)'s generator step(2^20), the GF(2^31 - 1) degree-16 FLFSR
step(2^18), and 2^14 ticks of the order-8192 register that
berlekamp_massey finds for 2^14 random GF(2) elements (the tick-by-tick
form in shared memory); K13, the Berlekamp-Massey scan of those elements.
Then the first step(n) of a new register, n = 64, 1000 and 2^20 (wall
time, synchronized, after the same calls on another register of the same
polynomial): the GF(2) degree-20 FLFSR, the GF(2^8) GLFSR, the GF(2^31 - 1)
degree-16 FLFSR, and degree-16 FLFSRs over GF(65537) and GF(3^5), whose
plain tick loop is a chain of torch passes; three new registers each.
``--k12-only`` leaves out K14. ``--k13-only`` times K13 alone (CUDA events
around eager calls) on main path 8's three sequences: 2^14 random GF(2)
elements, 8192 outputs of the GF(2^8) GLFSR of RS(255,223)'s generator
(L = 32) and 4096 of a GF(2^31 - 1) degree-16 FLFSR (L = 16), then random
sequences (complexity near N / 2, the CTA-wide form): 8192 GF(2^8)
elements, 2^16 GF(2) elements, 20000 GF(2^31 - 1) elements (too long for
shared memory: the global-scratch form), 8192 GF(2^16) elements (a table
field whose tables stay in global memory) and 8192 GF(2^17) elements (a
binary field on carry-less products); each line carries a digest of (c, L),
so that two trees' results can be compared; then the three public
``berlekamp_massey(seq, output="fibonacci")`` calls, and one cProfile of the
GF(2) call (its 25 most expensive functions by cumulative time). One JSON
line per call, the card's name and power limit first.
"""

import cProfile
import hashlib
import inspect
import io
import json
import pstats
import sys
import time

import numpy as np
import torch
from _timing import card, eager_ms, graph_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_limb_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt
    from galois_tpu_torch.ops._lfsr_scan import lfsr_step

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    label = args[0] if args else gt.__file__
    # a tree whose lfsr_step keeps the block form in the caller's dict gets one, so that the
    # timed calls reuse it as a register does
    keep = {"blocks": {}} if "blocks" in inspect.signature(lfsr_step).parameters else {}
    dev = torch.device("cuda")
    print(card(), flush=True)

    def emit(name, ms, **kw):
        print(json.dumps({"tree": label, "call": name, "ms": ms, **kw}), flush=True)

    if "--k13-only" in sys.argv:
        k13(gt, dev, emit)
        return 0
    if "--k12-only" not in sys.argv:
        k14(gt, dev, emit)
    k12(gt, dev, emit, keep)
    return 0


def k13_sequences(gt, dev):
    """(label, field, storage tensor) of main path 8's three Berlekamp-Massey
    sequences and five random ones of complexity near N / 2."""
    F2, F8, FM, F16, F17 = gt.GF(2), gt.GF(2**8), gt.GF(2**31 - 1), gt.GF(2**16), gt.GF(2**17)
    gen = gt.ReedSolomon(255, 223).generator_poly
    G = gt.GLFSR(gen.reverse(), state=F8(np.random.default_rng(81).integers(0, 256, 32), device=dev))
    rng = np.random.default_rng(82)
    cm = [1] + [int(v) for v in rng.integers(1, 2**31 - 1, 16)]
    LM = gt.FLFSR(gt.Poly(cm, field=FM).reverse(), state=FM(rng.integers(0, 2**31 - 1, 16), device=dev))
    return [
        ("GF(2) 2^14 random", F2, F2(np.random.default_rng(14).integers(0, 2, 2**14), device=dev)),
        ("GF(2^8) 8192 GLFSR outputs (L = 32)", F8, G.step(8192)),
        ("GF(2^31-1) 4096 FLFSR outputs (L = 16)", FM, LM.step(4096)),
        ("GF(2^8) 8192 random", F8, F8(np.random.default_rng(83).integers(0, 256, 8192), device=dev)),
        ("GF(2) 2^16 random", F2, F2(np.random.default_rng(84).integers(0, 2, 2**16), device=dev)),
        ("GF(2^31-1) 20000 random (global scratch)", FM, FM(np.random.default_rng(85).integers(0, 2**31 - 1, 20000), device=dev)),
        ("GF(2^16) 8192 random (tables in global memory)", F16, F16(np.random.default_rng(86).integers(0, 2**16, 8192), device=dev)),
        ("GF(2^17) 8192 random", F17, F17(np.random.default_rng(87).integers(0, 2**17, 8192), device=dev)),
    ]


def k13(gt, dev, emit):
    """K13 alone, then the public calls and one profile of the GF(2) one."""
    from galois_tpu_torch.ops import _lfsr_scan
    from galois_tpu_torch.ops._kernels import get_ops

    def digest(c, L):
        return hashlib.sha256(c.cpu().numpy().tobytes() + str(int(L)).encode()).hexdigest()[:16]

    seqs = k13_sequences(gt, dev)
    for label, F, x in seqs:
        ops = get_ops(F._meta, F._mode)
        ms = eager_ms(lambda: _lfsr_scan.berlekamp_massey_long(ops, x._data), 3)
        c, L = _lfsr_scan.berlekamp_massey_long(ops, x._data)
        emit(f"K13 {label}", ms, us_a_step=ms / x.size * 1e3, L=int(L), digest=digest(c, L))
    for label, F, x in seqs[:3]:
        ms = eager_ms(lambda: gt.berlekamp_massey(x, output="fibonacci"), 3)
        emit(f"berlekamp_massey {label}", ms)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    gt.berlekamp_massey(seqs[0][2], output="fibonacci")
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(25)
    print(out.getvalue(), flush=True)


def k14(gt, dev, emit):
    """K14 and main path 8's GF(2^m > 32) calls."""
    from galois_tpu_torch.ops._limb_binary import gf2_limb_multiply, gf2_limb_power

    F = gt.GF(2**128, irreducible_poly="x^128 + x^7 + x^2 + x + 1")
    m, f = 128, F._meta.irreducible_poly_int
    x = F.Random(2**24, seed=1, device=dev)
    y = F.Random(2**24, low=1, seed=2, device=dev)
    emit("K14 product GF(2^128) 2^24 (graph replay)", graph_ms(lambda: gf2_limb_multiply(x._data, y._data, m, f), 10))
    u = y._data[:, : 2**22]
    emit("K14 reciprocal GF(2^128) 2^22 (graph replay)", graph_ms(lambda: gf2_limb_power(u, 2**m - 2, m, f), 2))
    e = np.random.default_rng(80).integers(0, 2**63 - 1, 2**24, dtype=np.int64)
    words = [torch.as_tensor(e & (2**62 - 1), device=dev), torch.as_tensor(e >> 62, device=dev)]
    emit("K14 power, 63-bit exponent words, GF(2^128) 2^24 (graph replay)",
         graph_ms(lambda: gf2_limb_power(x._data, words, m, f, 63), 2))
    for name, fn in (("x * y", lambda: x * y), ("np.reciprocal(y)", lambda: np.reciprocal(y)), ("x / y", lambda: x / y),
                     ("x ** e", lambda: x**e), ("np.sqrt(x)", lambda: np.sqrt(x))):
        emit(f"GF(2^128) {name}, 2^24", eager_ms(fn, 1))
    del x, y, u, words
    F = gt.GF(2**233, irreducible_poly="x^233 + x^74 + 1")
    y = F.Random(2**22, low=1, seed=4, device=dev)
    emit("GF(2^233) np.reciprocal(y), 2^22", eager_ms(lambda: np.reciprocal(y), 1))
    del y
    torch.cuda.empty_cache()


def k12(gt, dev, emit, keep):
    """K12 and K13, then the first steps of new registers."""
    from galois_tpu_torch.ops._kernels import get_ops
    from galois_tpu_torch.ops._lfsr_scan import berlekamp_massey_long, lfsr_step

    F2 = gt.GF(2)
    ops2 = get_ops(F2._meta, F2._mode)
    c = gt.primitive_poly(2, 20)
    state = [int(v) for v in np.random.default_rng(80).integers(0, 2, 20)]
    state[0] = 1
    L = gt.FLFSR(c.reverse(), state=F2(state, device=dev))
    st, tp = L.state._data, L.taps._data
    ms = eager_ms(lambda: lfsr_step(ops2, st, tp, 2**14, "fibonacci", "forward", **keep), 3)
    emit("K12 GF(2) degree 20, 2^14 ticks", ms, us_a_tick=ms / 2**14 * 1e3)
    ms = eager_ms(lambda: L.step(2**20), 1)
    emit("GF(2) FLFSR degree 20, step(2^20)", ms, us_a_tick=ms / 2**20 * 1e3)
    ms = eager_ms(lambda: L.step(-(2**20 - 1)), 1)
    emit("GF(2) FLFSR degree 20, step(-(2^20 - 1))", ms, us_a_tick=ms / (2**20 - 1) * 1e3)
    F8 = gt.GF(2**8)
    gen = gt.ReedSolomon(255, 223).generator_poly
    G = gt.GLFSR(gen.reverse(), state=F8(np.random.default_rng(81).integers(0, 256, 32), device=dev))
    ms = eager_ms(lambda: G.step(2**20), 1)
    emit("GF(2^8) GLFSR degree 32, step(2^20)", ms, us_a_tick=ms / 2**20 * 1e3)
    FM = gt.GF(2**31 - 1)
    rng = np.random.default_rng(82)
    cm = [1] + [int(v) for v in rng.integers(1, 2**31 - 1, 16)]
    LM = gt.FLFSR(gt.Poly(cm, field=FM).reverse(), state=FM(rng.integers(0, 2**31 - 1, 16), device=dev))
    ms = eager_ms(lambda: LM.step(2**18), 1)
    emit("GF(2^31-1) FLFSR degree 16, step(2^18)", ms, us_a_tick=ms / 2**18 * 1e3)
    seq = F2(np.random.default_rng(14).integers(0, 2, 2**14), device=dev)._data
    ms = eager_ms(lambda: berlekamp_massey_long(ops2, seq), 3)
    emit("K13 GF(2) N=2^14", ms, us_a_step=ms / 2**14 * 1e3)
    cc, Lc = berlekamp_massey_long(ops2, seq)
    k = int(Lc)
    st, tp = seq[:k].flip(0).contiguous(), cc[1 : k + 1].contiguous()
    ms = eager_ms(lambda: lfsr_step(ops2, st, tp, 2**14, "fibonacci", "forward"), 3)
    emit(f"K12 GF(2) order {k} (shared memory), 2^14 ticks", ms, us_a_tick=ms / 2**14 * 1e3)

    # the first step(n) of a new register: the block form's build (or not) and the launch
    rng = np.random.default_rng(83)
    regs = [("GF(2) FLFSR degree 20", gt.FLFSR, c.reverse()), ("GF(2^8) GLFSR degree 32", gt.GLFSR, gen.reverse()),
            ("GF(2^31-1) FLFSR degree 16", gt.FLFSR, gt.Poly(cm, field=FM).reverse())]
    for q in (65537, 3**5):
        Fq = gt.GF(q)
        poly = gt.Poly([1] + [int(v) for v in rng.integers(1, q, 16)], field=Fq).reverse()
        regs.append((f"GF({q}) FLFSR degree 16", gt.FLFSR, poly))
    for name, cls, poly in regs:
        Fq = poly.field
        state = Fq(rng.integers(1, Fq.order, poly.degree), device=dev)
        for n in (64, 1000, 2**20):
            cls(poly, state=state).step(n)  # the kernel's first launch in this mode
            times = []
            for _ in range(3):
                reg = cls(poly, state=state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reg.step(n)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            emit(f"first step({n}) of a new {name}", min(times), wall_ms=times)


if __name__ == "__main__":
    sys.exit(main())
