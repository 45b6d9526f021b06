"""The one generator of decode traffic: a mix file's parameters to received
words, on the device, from the seed.

A mix (``portbench/mixes/<name>.json``) gives ``batch`` words a call, a
``ring`` of distinct batches that the calls take in turn, and how words are
hit: ``errors`` [lo, hi] symbol errors a word, with ``beyond`` {"every": E,
"errors": [lo, hi]} for every E-th word; or ``erasures`` [lo, hi] erasures a
word with ``errors_budget`` b, so that a word with f erasures takes e errors,
0 <= e <= (b - f) / 2. The counts of a batch are one fixed multiset, the
same for every seed, that the seed shuffles over the rows: the seed changes
which words, positions and values, never how much work a batch holds.
Errors and erasures fall at distinct random positions; an error adds a
random nonzero symbol, and so does the garbage under an erasure.
"""

from __future__ import annotations

import torch

__all__ = ["counts", "make_batch"]


def counts(mix: dict):
    """The multiset of (errors, erasures) a batch holds, before shuffling:
    two (batch,) int64 tensors on the CPU."""
    rows = torch.arange(mix["batch"], dtype=torch.int64)
    if "erasures" in mix:
        lo, hi = mix["erasures"]
        span = hi - lo + 1
        era = lo + rows % span
        cap = (mix["errors_budget"] - era) // 2
        err = (rows // span) % (cap + 1)
        return err, era
    lo, hi = mix["errors"]
    err = lo + rows % (hi - lo + 1)
    beyond = mix.get("beyond")
    if beyond:
        blo, bhi = beyond["errors"]
        every = beyond["every"]
        far = rows % every == 0
        err = torch.where(far, blo + (rows // every) % (bhi - blo + 1), err)
    return err, torch.zeros_like(err)


def make_batch(mix: dict, code, symbol_order: int, gen: torch.Generator):
    """One batch: (messages (B, k), received (B, n) int64, erasure mask
    (B, n) bool or None, errors (B,), erasures (B,)), on the generator's
    device; ``code`` encodes (the plain reference)."""
    dev = gen.device
    B, n = mix["batch"], code.n
    err, era = counts(mix)
    perm = torch.randperm(B, generator=gen, device=dev)
    err, era = err.to(dev)[perm], era.to(dev)[perm]
    msg = torch.randint(0, symbol_order, (B, code.k), generator=gen, device=dev)
    word = code.encode(msg)
    rank = torch.rand((B, n), generator=gen, device=dev).argsort(dim=1).argsort(dim=1)
    hit = rank < (era + err)[:, None]
    noise = torch.randint(1, symbol_order, (B, n), generator=gen, device=dev)
    received = word ^ torch.where(hit, noise, torch.zeros_like(noise))
    mask = rank < era[:, None] if "erasures" in mix else None
    return msg, received, mask, err, era
