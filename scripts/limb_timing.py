#!/usr/bin/env python3
"""Time the limb-field NTT of the galois_tpu_torch package found first on
the path and its parts, on one CUDA card.

    PYTHONPATH=<tree> python3 scripts/limb_timing.py [label]

For the BLS12-381 scalar field (16 limbs) and Goldilocks (4 limbs) at
N = 2^24 (a 4096 x 4096 plan): one side's limb matmul (the 4096 x 4096 DFT
table against the data) with the output-chunk budget ``_CHUNK_BYTES`` at
2, 4 and 8 GiB (the results must be equal) and its device time by kernel
(``torch.profiler``), the twiddle multiply, and a forward transform, each
timed eagerly by CUDA events, with the peak device memory of each; then
``torch._int_mm`` at the shapes of one output chunk's products. One JSON
line per case, the card's name and power limit first.
"""

import json
import sys

import torch
from _timing import card, eager_ms

BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
GOLDILOCKS = 2**64 - 2**32 + 1


def main() -> int:
    if not torch.cuda.is_available():
        print("limb_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import numpy as np

    import galois_tpu_torch as gt
    from galois_tpu_torch.ops import _limb_matmul, _ntt

    label = sys.argv[1] if len(sys.argv) > 1 else ""
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": card(), "label": label, "torch": torch.__version__}), flush=True)

    def timed(name, field, fn, reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = eager_ms(fn, reps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(json.dumps({"label": label, "field": field, "case": name, "ms": ms, "peak_gib": peak}), flush=True)

    for p, field in ((BLS_R, "BLS12-381 r"), (GOLDILOCKS, "Goldilocks")):
        F = gt.GF(p)
        N = 2**24
        x = F.Random(N, seed=1, device=dev)
        plan = _ntt._plan(F._meta, N, _ntt._get_omega(F, N), F._mode, dev)
        M = x._data.reshape(-1, plan.n1, plan.n2)
        saved = _limb_matmul._CHUNK_BYTES
        results = []
        try:
            for budget in (2**31, 2**32, 2**33):
                _limb_matmul._CHUNK_BYTES = budget
                results.append(_limb_matmul.limb_matmul(F._meta, plan.w1, M))
                timed(f"side limb matmul, chunk budget {budget // 2**30} GiB", field,
                      lambda: _limb_matmul.limb_matmul(F._meta, plan.w1, M), 2)
                if not torch.equal(results[0], results[-1]):
                    raise AssertionError(f"{field}: the side's product depends on the chunk budget")
                del results[1:]
        finally:
            _limb_matmul._CHUNK_BYTES = saved
        del results
        # where one side's device time goes, by kernel
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _limb_matmul.limb_matmul(F._meta, plan.w1, M)
            torch.cuda.synchronize()
        rows = sorted(
            (e for e in prof.key_averages() if e.self_device_time_total > 0),
            key=lambda e: -e.self_device_time_total,
        )[:12]
        for e in rows:
            print(json.dumps({"label": label, "field": field, "case": "side limb matmul by kernel", "kernel": e.key[:120],
                              "ms": e.self_device_time_total / 1e3, "calls": e.count}), flush=True)
        timed("twiddle multiply", field, lambda: _ntt._multiply_chunked(plan.ops, M, plan.t), 2)
        timed("forward transform", field, lambda: np.fft.fft(x), 2)
        del x, M, plan
        _ntt._plan.cache_clear()
        torch.cuda.empty_cache()
    # torch._int_mm (both operands K-major) at the shapes of one output chunk's
    # products: K = 2048 (one digit pair) to 32 x 2048 (the middle diagonal)
    g = torch.Generator(device=dev).manual_seed(0)
    for nc in (160, 352, 1024):
        for k in (2048, 16 * 2048, 32 * 2048):
            a8 = torch.randint(-128, 128, (4096, k), generator=g, device=dev, dtype=torch.int8)
            b8 = torch.randint(-128, 128, (nc, k), generator=g, device=dev, dtype=torch.int8)
            ms = eager_ms(lambda: torch._int_mm(a8, b8.T), 5)
            print(json.dumps({"label": label, "case": "int8 GEMM, B K-major", "M": 4096, "K": k, "N": nc, "ms": ms,
                              "TOPS": 2 * 4096 * k * nc / ms / 1e9}), flush=True)
            del a8, b8
    return 0


if __name__ == "__main__":
    sys.exit(main())
