#!/usr/bin/env python3
"""Time the lookup-mode kernels (K3 multiply, K4 divide, K5 reciprocal,
K6 log) of the galois_tpu_torch package found first on the path, on one
CUDA card.

    PYTHONPATH=<tree> python3 scripts/lookup_timing.py [label]

For GF(2^8), GF(3^5), GF(2^10) and GF(2^16) at 2^24 elements and GF(2^8) at
2^20 and at 2^26 (tensors of 64 MB, past the 50 MB L2), each kernel is
checked against its plain version once and then timed by CUDA-graph replay
(the mean of one replay of `reps` launches), K3 also on views one element
off alignment at GF(2^8) and GF(2^16), 2^24, and on int64 storage
torch.take of a q-entry reciprocal or log table beside K5 and K6; one JSON
line per case. Last, the public call np.reciprocal(y) on 2^24 nonzero
elements of GF(2^16) in lookup mode, timed eagerly by CUDA events (host
time included), as main path 2 of chip_smoke.py times it. It runs against trees whose wrappers take the packed tables
(`pack_tables`) and against those that do not, so that two commits can be
compared in one call: run it with each tree's path in turn.
"""

import inspect
import json
import sys

import numpy as np
import torch
from _timing import card, eager_ms, graph_ms

CASES = [
    (2**8, 2**24, 50), (3**5, 2**24, 50), (2**10, 2**24, 20), (2**16, 2**24, 20), (2**8, 2**20, 200), (2**8, 2**26, 20),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("lookup_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt
    from galois_tpu_torch.ops import _lookup
    from galois_tpu_torch.ops._kernels import get_ops

    label = sys.argv[1] if len(sys.argv) > 1 else gt.__file__
    dev = torch.device("cuda", 0)
    smi = card()
    gen = torch.Generator(device=dev).manual_seed(7)
    for q, n, reps in CASES:
        F = gt.GF(q)
        ops = get_ops(F._meta, "jit-lookup")
        exp_t, log_t = (torch.from_numpy(t).to(dev) for t in (ops.EXP, ops.LOG))
        dt = F._meta.torch_dtype
        extra = ()
        place = "shared" if q <= _lookup.SMEM_MAX_ORDER else "global"
        if hasattr(_lookup, "pack_tables"):
            extra = (_lookup.pack_tables(exp_t, log_t, q, dt),)
            place = _lookup.lookup_placement(q, dt)
        a = torch.randint(0, q, (n,), generator=gen, device=dev).to(dt)
        b = torch.randint(0, q, (n,), generator=gen, device=dev).to(dt)
        a[::1009] = 0
        b[::997] = 0
        row = {"tree": label, "device": smi, "q": q, "n": n, "placement": place}
        for name, kernel, plain in (
            ("K3", _lookup.lookup_multiply, _lookup.lookup_multiply_plain),
            ("K4", _lookup.lookup_divide, _lookup.lookup_divide_plain),
        ):
            got = kernel(a, b, exp_t, log_t, q, *extra)
            if not torch.equal(got, plain(a, b, exp_t, log_t, q)):
                raise AssertionError(f"{name} disagrees with its plain version on GF({q}), n = {n}")
            row[f"{name}_ms"] = graph_ms(lambda: kernel(a, b, exp_t, log_t, q, *extra), reps)
        unary_extra = extra if "packed" in inspect.signature(_lookup.lookup_reciprocal).parameters else ()
        for name, kernel, plain in (
            ("K5", lambda: _lookup.lookup_reciprocal(a, exp_t, log_t, q, *unary_extra),
             lambda: _lookup.lookup_reciprocal_plain(a, exp_t, log_t, q)),
            ("K6", lambda: _lookup.lookup_log(a, log_t, q, *unary_extra), lambda: _lookup.lookup_log_plain(a, log_t, q)),
        ):
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"{name} disagrees with its plain version on GF({q}), n = {n}")
            row[f"{name}_ms"] = graph_ms(kernel, reps)
        if dt == torch.int64:  # the yardsticks: one torch call for the same map
            inv64 = _lookup.lookup_reciprocal_plain(torch.arange(q, device=dev), exp_t, log_t, q)
            log64 = log_t.to(torch.int64)
            row["take_inv_ms"] = graph_ms(lambda: torch.take(inv64, a), reps)
            row["take_log_ms"] = graph_ms(lambda: torch.take(log64, a), reps)
        if n == 2**24 and q in (2**8, 2**16):  # views one element off alignment
            x, y = a[1:], b[:-1]
            if not torch.equal(_lookup.lookup_multiply(x, y, exp_t, log_t, q, *extra), _lookup.lookup_multiply_plain(x, y, exp_t, log_t, q)):
                raise AssertionError(f"K3 disagrees with its plain version on unaligned views of GF({q})")
            row["K3_unaligned_ms"] = graph_ms(lambda: _lookup.lookup_multiply(x, y, exp_t, log_t, q, *extra), reps)
        print(json.dumps(row), flush=True)
        del a, b, got
        torch.cuda.empty_cache()
    F = gt.GF(2**16, compile="jit-lookup")
    try:
        y = F.Random(2**24, seed=10, low=1, device=dev)
        ms = eager_ms(lambda: np.reciprocal(y), 20)
        print(json.dumps({"tree": label, "device": smi, "q": 2**16, "n": 2**24, "np_reciprocal_eager_ms": ms}))
    finally:
        F.compile("auto")
    return 0


if __name__ == "__main__":
    sys.exit(main())
