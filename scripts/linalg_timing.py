#!/usr/bin/env python3
"""Time main path 6's calls (linear algebra over GF(q)) of the
galois_tpu_torch package found first on the path, on one CUDA card, and
show where their time goes.

    PYTHONPATH=<tree> python3 scripts/linalg_timing.py [label]

In a fresh process, after one warm-up call of each at n = 128 (128 x 640
for GF(2)): GF(2) row_reduce of mceliece8192128's 1664 x 8192 parity-check
matrix H (the one chip_smoke.py reduces, from the same seed), GF(2^8) inv
at n = 1024 in both modes, GF(2^16) inv at n = 512, GF(2^31 - 1) det at
n = 1024 and Goldilocks inv at n = 256, one call each timed by CUDA events,
with the kernel launches of the call and its time per column step. Then
the GF(2) row_reduce of H, and of H with its last row replaced by its
first (rank 1663: no early exit, 8192 column steps), at each period of
``_row_reduce_data``'s early-exit check in EXIT_CHECK_PERIODS,
EXIT_CHECK_REPS times over in alternation, with H's last pivot column, the
column steps and read-backs of each period, and the least and the median
time of each. Then the GF(2^8) inv and the GF(2) row_reduce under
torch.profiler (device busy time against the call's time, the largest
kernels by device time), and the first calls timed again after the
profiler. One JSON line per case, the card's name and power limit first.
"""

import json
import sys

import torch
from _timing import card, mceliece_parity_check

M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1
EXIT_CHECK_PERIODS = (1, 16, 32, 64, 256)
EXIT_CHECK_REPS = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("linalg_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import numpy as np

    import galois_tpu_torch as gt
    from galois_tpu_torch.ops import _elementwise, _linalg, _lookup

    label = sys.argv[1] if len(sys.argv) > 1 else ""
    dev = torch.device("cuda", 0)
    print(json.dumps({"card": card(), "label": label, "torch": torch.__version__}), flush=True)
    counters = (
        _elementwise.gf2m_multiply_swar, _elementwise.gf2m_power, _elementwise.gf2m_multiply,
        _lookup.lookup_multiply, _lookup.lookup_reciprocal, _elementwise.m31_multiply,
        _elementwise.goldilocks_multiply,
    )

    def one_call(call):
        """(ms by CUDA events, launches by wrapper) of one call."""
        before = {fn.__name__: fn.launches for fn in counters}
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        used = {k: fn.launches - before[k] for k, fn in zip(before, counters) if fn.launches > before[k]}
        return start.elapsed_time(end), used

    def matrix(q, shape, seed):
        """A random matrix (invertible with a chance above 1 - 1/(q - 1) for q > 2)."""
        rng = np.random.default_rng(seed)
        if q <= 2**62:
            return gt.GF(q)(rng.integers(0, q, shape), device=dev)
        return gt.GF(q)((rng.integers(0, 2**62, shape).astype(object) * 4 + 1) % q, device=dev)

    # (case, field order, mode, full-size shape, warm-up shape, call, column steps of the full call)
    cases = [
        ("GF(2) row_reduce", 2, "jit-calculate", (1664, 8192), (128, 640), lambda A: A.row_reduce(), None),
        ("GF(2^8) inv", 2**8, "jit-calculate", (1024, 1024), (128, 128), np.linalg.inv, 1024),
        ("GF(2^8) inv", 2**8, "jit-lookup", (1024, 1024), (128, 128), np.linalg.inv, 1024),
        ("GF(2^16) inv", 2**16, "jit-calculate", (512, 512), (128, 128), np.linalg.inv, 512),
        ("GF(2^31-1) det", M31, "jit-calculate", (1024, 1024), (128, 128), np.linalg.det, 1023),
        ("Goldilocks inv", GOLDILOCKS, "jit-calculate", (256, 256), (128, 128), np.linalg.inv, 256),
    ]
    H = gt.GF(2)._view(mceliece_parity_check(gt, dev, np.random.default_rng(60), 13, 128, 8192))
    inputs = [H] + [matrix(q, shape, 10 + k) for k, (_, q, _, shape, _, _, _) in enumerate(cases) if k]

    def run(phase):
        for (name, q, mode, shape, warm, call, steps), A in zip(cases, inputs):
            F = gt.GF(q)
            F.compile(mode)
            try:
                if phase == "fresh process":
                    call(A[: warm[0], : warm[1]])
                ms, used = one_call(lambda: call(A))
            finally:
                F.compile("auto")
            row = {"label": label, "phase": phase, "case": name, "mode": mode, "shape": list(shape), "ms": ms,
                   "launches": used}
            if steps:
                row["ms_per_column_step"] = ms / steps
            print(json.dumps(row), flush=True)

    def sweep(reps):
        """The early exit: H's rank is M at its last pivot column c; period P
        exits at the first j >= max(c, M - 1) with (j - M + 1) % P == 0."""
        M, N = H.shape
        R = H.row_reduce()._data
        c = int((R[M - 1] != 0).to(torch.int32).argmax())
        short = H._data.clone()
        short[M - 1] = short[0]
        deficient = gt.GF(2)._view(short)
        times = {}
        saved = _linalg._EXIT_CHECK_EVERY
        try:
            for rep in range(reps):
                for P in EXIT_CHECK_PERIODS:
                    _linalg._EXIT_CHECK_EVERY = P
                    checks = range(M - 1, N - 1, P)
                    for name, A, stop in (("H", H, c), ("H rank 1663", deficient, N)):
                        ms, _ = one_call(lambda: A.row_reduce())
                        times.setdefault((name, P), []).append(ms)
                        steps = next((j + 1 for j in checks if j >= stop), N)
                        print(json.dumps({
                            "label": label, "phase": "exit-check period", "rep": rep, "case": name,
                            "period": P, "last_pivot_column": c, "ms": ms, "column_steps": steps,
                            "read_backs": sum(1 for j in checks if j < steps),
                        }), flush=True)
        finally:
            _linalg._EXIT_CHECK_EVERY = saved
        for (name, P), ms in times.items():
            print(json.dumps({"label": label, "phase": "exit-check period, summary", "case": name, "period": P,
                              "reps": reps, "min_ms": min(ms), "median_ms": sorted(ms)[reps // 2]}), flush=True)

    run("fresh process")
    sweep(EXIT_CHECK_REPS)
    from torch.profiler import ProfilerActivity, profile

    for k in (1, 0):
        name, q, mode, shape, _, call, _ = cases[k]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ms, _ = one_call(lambda: call(inputs[k]))
        kernels = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[ev.key] = kernels.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({
            "label": label, "phase": "torch.profiler", "case": name, "shape": list(shape), "ms": ms,
            "device_busy_ms": busy, "device_idle_share": 1 - busy / ms,
            "top_kernels_ms": {key[:80]: v for key, v in top},
        }), flush=True)
    run("after torch.profiler")
    return 0


if __name__ == "__main__":
    sys.exit(main())
