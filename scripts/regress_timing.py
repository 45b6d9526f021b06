#!/usr/bin/env python3
"""Time a few calls of chip_smoke.py's main paths 2, 4 and 7 for the
galois_tpu_torch package found first on the path, on one CUDA card, so that
two commits can be compared in one call by running it with each tree's path
in turn (parent, change, change, parent).

    PYTHONPATH=<tree> python3 scripts/regress_timing.py [label]

The calls, at chip_smoke.py's shapes and seeds: the BCH(511,493) encode of
16384 messages; GF(2^8) jit-lookup x ** e at 2^24 elements with an int64
exponent array in [0, 1000); GF(3^5) x + y and x / y at 2^24; GF(3^5)
field_norm at 2^24; the Goldilocks np.sqrt of y * y at 2^24 (Tonelli-
Shanks). For each: the mean ms of eager calls (CUDA events around the
Python calls), then one call under torch.profiler: its CUDA kernels, their
summed device time and the call's wall time, so that a change in host time
is told from one in device work. One JSON line per call, the card's name
and power limit first.
"""

import json
import sys
import time

import numpy as np
import torch
from _timing import card, eager_ms


def profiled(fn):
    """(kernels launched, their summed device ms, wall ms) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3, wall


def main() -> int:
    if not torch.cuda.is_available():
        print("regress_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt

    label = sys.argv[1] if len(sys.argv) > 1 else gt.__file__
    dev = torch.device("cuda")
    print(card(), flush=True)
    n = 2**24

    bch = gt.BCH(511, 493)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    msg = bch.field.Random((16384, bch.k), generator=gen, device=dev)
    GF8 = gt.GF(2**8)
    GF8.compile("jit-lookup")
    x8 = GF8.Random(n, seed=3, device=dev)
    e = np.random.default_rng(5).integers(0, 1000, n)
    GF35 = gt.GF(3**5)
    x35 = GF35.Random(n, seed=11, device=dev)
    y35 = GF35.Random(n, seed=12, low=1, device=dev)
    Fg = gt.GF(2**64 - 2**32 + 1)
    yg = Fg.Random(n, seed=13, device=dev)
    sq = yg * yg

    cases = [
        ("BCH(511,493) encode, 16384 messages", lambda: bch.encode(msg), 20),
        ("GF(2^8) jit-lookup x ** e, 2^24 elements", lambda: x8**e, 5),
        ("GF(3^5) x + y, 2^24 elements", lambda: x35 + y35, 5),
        ("GF(3^5) x / y, 2^24 elements", lambda: x35 / y35, 3),
        ("GF(3^5) field_norm(), 2^24 elements", lambda: x35.field_norm(), 3),
        ("Goldilocks np.sqrt(y * y), 2^24 elements", lambda: np.sqrt(sq), 2),
    ]
    for name, fn, reps in cases:
        ms = eager_ms(fn, reps)
        kernels, device_ms, wall_ms = profiled(fn)
        print(json.dumps({"tree": label, "call": name, "ms": ms, "reps": reps, "profiled_kernels": kernels,
                          "profiled_device_ms": device_ms, "profiled_wall_ms": wall_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
