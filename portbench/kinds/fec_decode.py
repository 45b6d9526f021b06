"""Batched decoding through the library's public codes.

The system under test is ``galois_tpu_torch``'s ``ReedSolomon`` or ``BCH``,
built from the configuration file; a call is ``code.decode(received,
erasures=mask, errors=True)`` of one batch of the ring, which returns the
decoded messages and the error counts (NumPy, read back by the call). The
words come from ``portbench/traffic.py`` and are encoded by the plain
reference; the library sees only the received words and the masks.

``correct`` compares, for every word of the first call on each batch of the
ring, the decoded message and the count with the plain reference's decode
of the same received word (the harness holds every later call on a batch
to that first call, row by row). The control puts the reference in the
library's place with its syndromes taken as bit-plane products in a lower
precision (``reference/cyclic_codes.py::syndromes_planes``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.cyclic_codes import code_from_config, syndromes_planes
from portbench.traffic import make_batch

__all__ = ["Cell"]

REFERENCE_ROWS = 16384  # rows the reference decodes at a time


@dataclass
class Slot:
    word: object  # the library's FieldArray of the received words
    mask: torch.Tensor  # (B, n) bool erasures, or None
    received: torch.Tensor  # the benchmark's own copy, int64, for the reference
    mask_copy: torch.Tensor


def build_code(gt, cfg: dict):
    """The library's code for a configuration file."""
    F = gt.GF(2 ** cfg["m"], irreducible_poly=cfg["field_poly"])
    alpha = F(2) ** cfg["alpha_exponent"]
    if cfg["code"] == "reed_solomon":
        return gt.ReedSolomon(cfg["n"], cfg["k"], c=cfg["c"], field=F, alpha=alpha)
    if cfg["code"] == "bch":
        return gt.BCH(cfg["n"], cfg["k"], extension_field=F, alpha=alpha, c=cfg["c"])
    raise ValueError(f"unknown code {cfg['code']!r}")


class Cell:
    """One configuration under one mix, on ``device``; with ``control`` (a
    precision of ``syndromes_planes``) the reference takes the library's
    place in ``call``."""

    def __init__(self, config: dict, mix: dict, device, control: str = None):
        import galois_tpu_torch as gt

        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.control = control
        gt.set_default_device(self.device)
        self.code = build_code(gt, config)
        self.ref = code_from_config(config, self.device)
        ours = [int(v) for v in self.code.generator_poly.coefficients()][::-1]
        if ours != self.ref.generator or self.code.d != config["d"]:
            raise ValueError("the library's code is not the configuration's: its generator or d differs")
        self.symbol_order = 2 if config["symbols"] == "GF(2)" else 1 << config["m"]
        self.items_per_call = mix["batch"]

    def make_ring(self, seed: int):
        """The mix's ring of batches for ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        ring = []
        for _ in range(self.mix["ring"]):
            _, received, mask, _, _ = make_batch(self.mix, self.ref, self.symbol_order, gen)
            storage = received.to(torch.uint8)
            ring.append(Slot(self.code.field(storage), None if mask is None else mask.clone(), received, mask))
        return ring

    def call(self, slot: Slot):
        """The timed call: (decoded messages (B, k) as a device tensor, counts)."""
        if self.control:
            words, cnt = self._decode_reference(slot, self.control)
            return words[:, : self.config["k"]].to(torch.uint8), cnt.cpu().numpy()
        out, cnt = self.code.decode(slot.word, erasures=slot.mask, errors=True)
        return out._data, cnt

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_reference(self, slot: Slot, precision: str = None):
        syn = None
        if precision:
            def syn(F, r, roots):
                return syndromes_planes(F, r, roots, precision)
        words, counts = [], []
        for s in range(0, slot.received.shape[0], REFERENCE_ROWS):
            rows = slice(s, s + REFERENCE_ROWS)
            mask = None if slot.mask_copy is None else slot.mask_copy[rows]
            w, c = self.ref.decode(slot.received[rows], mask, syndromes=syn)
            words.append(w)
            counts.append(c)
        return torch.cat(words), torch.cat(counts)

    def wrong_rows(self, slot: Slot, out: torch.Tensor, cnt: np.ndarray):
        """Rows whose decoded message, and rows whose count, differ from the
        plain reference's decode of the same received words."""
        words, counts = self._decode_reference(slot)
        k = self.config["k"]
        msg_bad = (out.to(torch.int64) != words[:, :k]).any(dim=1)
        cnt_bad = torch.from_numpy(np.asarray(cnt, dtype=np.int64)).to(counts.device) != counts
        return int(msg_bad.sum()), int(cnt_bad.sum()), int((msg_bad | cnt_bad).sum())
