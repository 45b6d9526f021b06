"""Timing helpers, decode inputs and the McEliece parity-check matrix shared
by chip_smoke.py and the timing scripts beside this file, for one CUDA card."""

import subprocess

import numpy as np
import torch


def eager_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps eager runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device time of fn() over reps runs captured in one CUDA graph
    and replayed: the launches run back to back, without the host time of
    each Python call."""
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
    del graph
    return start.elapsed_time(end) / reps


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ranks(B, n, gen):
    """Each row's positions in a random order: rank[i, j] is the place of
    position j in row i's permutation."""
    return torch.rand((B, n), generator=gen, device=gen.device).argsort(dim=1).argsort(dim=1)


def corrupt(data, hit, q, gen):
    """XOR a random nonzero symbol of GF(q) into the positions where ``hit`` holds."""
    noise = torch.randint(1, q, data.shape, generator=gen, device=gen.device)
    return data ^ torch.where(hit, noise, 0).to(data.dtype)


def mceliece_parity_check(gt, dev, rng, m, t, n):
    """A Classic McEliece parity-check matrix as a (t m, n) uint8 tensor of
    bits on ``dev`` (parameter set mceliece8192128: m = 13, t = 128, n = 8192):
    H[i, j] = alpha_j^i / g(alpha_j) over GF(2^m), i < t, alpha_j = j, the
    support the first n elements of GF(2^m), bit-expanded to mt x n;
    g monic of degree t with no root in the support, its coefficients drawn
    from ``rng`` (key generation takes g irreducible; the elimination does not
    depend on it)."""
    F = gt.GF(2**m)
    alpha = F._view(torch.arange(n, dtype=torch.int64, device=dev))
    while True:
        g = gt.Poly([1] + rng.integers(1, 2**m, t).tolist(), field=F)
        g_at = g(alpha)
        if not bool((g_at._data == 0).any()):
            break
    rows = [np.reciprocal(g_at)]
    for _ in range(t - 1):
        rows.append(rows[-1] * alpha)
    Hq = torch.stack([r._data for r in rows])
    return ((Hq[:, None, :] >> torch.arange(m, device=dev)[None, :, None]) & 1).reshape(t * m, n).to(torch.uint8)
