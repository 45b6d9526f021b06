#!/usr/bin/env python3
"""Time the lookup-mode multiply and divide kernels (K3, K4) of the
galois_tpu_torch package found first on the path, on one CUDA card.

    PYTHONPATH=<tree> python3 scripts/lookup_timing.py [label]

For GF(2^8), GF(3^5), GF(2^10) and GF(2^16) at 2^24 elements and GF(2^8) at
2^20 and at 2^26 (three tensors of 64 MB, past the 50 MB L2), each kernel
is checked against its plain version once and then timed by CUDA-graph
replay (the mean of one replay of `reps` launches), and K3 on views one
element off alignment at GF(2^8) and GF(2^16), 2^24; one JSON line per
case. It runs against trees whose wrappers take the packed tables
(`pack_tables`) and against those that do not, so that two commits can be
compared in one call: run it with each tree's path in turn.
"""

import json
import subprocess
import sys

import torch

CASES = [
    (2**8, 2**24, 50), (3**5, 2**24, 50), (2**10, 2**24, 20), (2**16, 2**24, 20), (2**8, 2**20, 200), (2**8, 2**26, 20),
]


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("lookup_timing: no CUDA device is available.", file=sys.stderr)
        return 1
    import galois_tpu_torch as gt
    from galois_tpu_torch.ops import _lookup
    from galois_tpu_torch.ops._kernels import get_ops

    label = sys.argv[1] if len(sys.argv) > 1 else gt.__file__
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
        if n == 2**24 and q in (2**8, 2**16):  # views one element off alignment
            x, y = a[1:], b[:-1]
            if not torch.equal(_lookup.lookup_multiply(x, y, exp_t, log_t, q, *extra), _lookup.lookup_multiply_plain(x, y, exp_t, log_t, q)):
                raise AssertionError(f"K3 disagrees with its plain version on unaligned views of GF({q})")
            row["K3_unaligned_ms"] = graph_ms(lambda: _lookup.lookup_multiply(x, y, exp_t, log_t, q, *extra), reps)
        print(json.dumps(row), flush=True)
        del a, b, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
