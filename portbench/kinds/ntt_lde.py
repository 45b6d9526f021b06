"""The coset low-degree extension of a batch of trace columns through the
library's public NTT.

The system under test is ``galois_tpu_torch``'s ``GF(p)`` for the
configuration's prime; a call is

    np.fft.fft(np.fft.ifft(x) * coset, n=blowup * N)

on a FieldArray ``x`` of shape (C, N), one batch of the ring, with
``coset`` the (N,) FieldArray of shift^i built once in set-up: NumPy's
norms, so the inverse scales by 1/N and the forward does not. The call
returns the output's planar limbs as a device tensor with one row a column
(C, 4 blowup N) and a (C,) host array of zeros: the transform has no count,
so ``count_rows_wrong`` is 0 by construction. The columns come from the
seed on the device (uniform in [0, p)); the library sees only their limbs.

A call holds at most the configuration's ``batch_max`` columns (64 MB of
input each at N = 2^23): a larger batch asked of the kind, as
``proof.py --batch`` asks one sized for codewords, is cut to it, and
``items_per_call`` counts the columns held.

``correct`` compares every column of the first call on each batch of the
ring with the plain reference's extension of the same column
(``reference/goldilocks_ntt.py``), element by element and exactly; the
harness holds every later call on a batch to that first call. The control
puts the reference in the library's place with the butterflies' products
taken on operands rounded to a float precision's significand (float64
by default; ``reference.goldilocks_ntt.lossy_mul``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import goldilocks_ntt as ref

__all__ = ["Cell"]

_M32 = 2**32 - 1


@dataclass
class Slot:
    word: object  # the library's FieldArray of the columns, (C, N)
    limbs: torch.Tensor  # the benchmark's own copy, (4, C, N) uint16


def make_columns(C: int, n: int, gen: torch.Generator):
    """C columns of n uniform elements of [0, p) as (hi, lo) int64 tensors on
    the generator's device: both halves drawn, the draws at or above p redrawn."""
    dev = gen.device
    hi = torch.randint(0, 2**32, (C, n), generator=gen, device=dev)
    lo = torch.randint(0, 2**32, (C, n), generator=gen, device=dev)
    while True:
        bad = ((hi == _M32) & (lo >= 1)).nonzero(as_tuple=True)
        if not bad[0].numel():
            return hi, lo
        hi[bad] = torch.randint(0, 2**32, (bad[0].numel(),), generator=gen, device=dev)
        lo[bad] = torch.randint(0, 2**32, (bad[0].numel(),), generator=gen, device=dev)


class Cell:
    """One configuration under one mix, on ``device``; with ``control`` (a
    float precision of ``reference.goldilocks_ntt.lossy_mul``) the reference
    takes the library's place in ``call``."""

    def __init__(self, config: dict, mix: dict, device, control: str = None):
        import galois_tpu_torch as gt

        if config["p"] != ref.P:
            raise ValueError("the reference holds Goldilocks only")
        self.mix, self.device = mix, torch.device(device)
        self.n, self.blowup, self.shift, self.g = config["n"], config["blowup"], config["shift"], config["generator"]
        self.butterfly_mul = ref.lossy_mul(control) if control else None
        gt.set_default_device(self.device)
        self.F = gt.GF(config["p"])
        if int(self.F.primitive_element) != self.g:
            raise ValueError("the library's generator is not the configuration's: its roots of unity differ")
        self.coset = self.F(self.shift, device=self.device) ** np.arange(self.n)
        self.items_per_call = min(mix["batch"], config["batch_max"])
        self._counts = np.zeros(self.items_per_call, dtype=np.int64)

    def make_ring(self, seed: int):
        """The mix's ring of batches for ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        ring = []
        for _ in range(self.mix["ring"]):
            limbs = ref.split_limbs(make_columns(self.items_per_call, self.n, gen)).to(torch.uint16)
            ring.append(Slot(self.F(limbs), limbs))
        return ring

    def call(self, slot: Slot):
        """The timed call: (the extended columns' limbs (C, 4 blowup N) as a
        device tensor, zeros)."""
        if self.butterfly_mul is not None:
            return self._reference(slot, self.butterfly_mul), self._counts
        y = np.fft.fft(np.fft.ifft(slot.word) * self.coset, n=self.blowup * self.n)
        return y._data.movedim(0, 1).reshape(y.shape[0], -1), self._counts

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _reference(self, slot: Slot, butterfly_mul=ref.mul) -> torch.Tensor:
        hi, lo = ref.lde(ref.join_limbs(slot.limbs), self.g, self.shift, self.blowup, butterfly_mul)
        return ref.split_limbs((hi, lo)).movedim(0, 1).reshape(hi.shape[0], -1)

    def wrong_rows(self, slot: Slot, out: torch.Tensor, cnt: np.ndarray):
        """Columns that differ anywhere from the plain reference's extension
        of the same column; the count is 0 by construction."""
        bad = (out.to(torch.int64) != self._reference(slot)).any(dim=1)
        n_bad = int(bad.sum())
        return n_bad, 0, n_bad
