"""Timing helpers and decode inputs shared by chip_smoke.py and the timing
scripts beside this file, for one CUDA card."""

import subprocess

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
