"""Linear block code base class.

Port of ``galois_tpu/codes/_linear.py`` (reference:
src/galois/_codes/_linear.py:18-465). Encode, detect and decode keep the
words on their device: encode concatenates storage tensors, detect reduces
the syndromes there, and only decode's error counts come back to the host,
as the NumPy array the API returns. G and H live on the device the code was
built on; a word on another device gets a copy of them, made once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._tracing import span
from ..fields._array import FieldArray
from ..ops._linalg import matmul

__all__ = ["generator_to_parity_check_matrix", "parity_check_to_generator_matrix"]


class _LinearCode:
    """An [n, k, d] linear block code over GF(q)."""

    def __init__(self, n: int, k: int, d: int, G, H, systematic: bool):
        self._n = int(n)
        self._k = int(k)
        self._d = int(d)
        self._G = G
        self._H = H
        self._is_systematic = bool(systematic)
        self._field = type(G)
        self._copies = {}
        if G.shape != (k, n):
            raise ValueError(f"Generator matrix must be {(k, n)}, not {G.shape}.")

    def _matrix_on(self, name: str, device: torch.device) -> FieldArray:
        """G or H on ``device``."""
        M = getattr(self, name)
        if M.device == device:
            return M
        if (name, device) not in self._copies:
            self._copies[(name, device)] = type(M)._view(M._data.to(device), M._dtype)
        return self._copies[(name, device)]

    # ------------------------------------------------------------------
    # Encode (reference: _linear.py:58-93,270-284)
    # ------------------------------------------------------------------

    def encode(self, message, output: str = "codeword"):
        if output not in ("codeword", "parity"):
            raise ValueError(f"Argument 'output' must be 'codeword' or 'parity', not {output!r}.")
        if output == "parity" and not self.is_systematic:
            raise ValueError("Argument 'output' can only be 'parity' for systematic codes.")
        message = self.field(message)
        is_1d = message.ndim == 1
        if message.ndim not in (1, 2):
            raise ValueError(f"Argument 'message' must be 1-D or 2-D, not {message.ndim}-D.")
        ks = message.shape[-1]
        if not 1 <= ks <= self.k:
            raise ValueError(
                f"Argument 'message' must have last dimension in [1, {self.k}] "
                f"(shortened codes elide leading symbols), not {ks}."
            )
        s = self.k - ks  # number of shortened symbols

        m2 = message.reshape(1, ks) if is_1d else message
        G = self._matrix_on("_G", m2.device)
        if self.is_systematic:
            parity = matmul(m2, G[s:, self.k :])
            if output == "parity":
                out = parity
            else:
                # [m | parity]: the symbol axis is the last storage axis
                out = self.field._view(torch.cat([m2._data, parity._data], dim=-1), m2._dtype)
        else:
            out = matmul(m2, G[s:, s:])
        return out[0] if is_1d else out

    # ------------------------------------------------------------------
    # Detect (reference: _linear.py:95-117)
    # ------------------------------------------------------------------

    def detect(self, codeword):
        codeword = self.field(codeword)
        is_1d = codeword.ndim == 1
        ns = codeword.shape[-1]
        s = self.n - ns
        c2 = codeword.reshape(1, ns) if is_1d else codeword
        syndrome = matmul(c2, self._matrix_on("_H", c2.device)[:, s:].T)
        # zero is all-zero storage in every storage kind
        nz = syndrome._data != 0
        if self.field._storage_ndim():
            nz = nz.any(dim=0)  # the planar limb axis leads
        detected = nz.any(dim=-1).cpu().numpy()
        return bool(detected[0]) if is_1d else detected

    # ------------------------------------------------------------------
    # Decode driver (reference: _linear.py:119-186)
    # ------------------------------------------------------------------

    def decode(self, codeword, erasures=None, output: str = "message", errors: bool = False):
        """Decode a (B, n) batch or one word, on its device. ``erasures``, a
        boolean mask of the codeword's shape, may be a NumPy array or a
        tensor. Returns the messages (or codewords) and, with
        ``errors=True``, the corrected-symbol counts as int64 NumPy (-1 where
        decoding failed)."""
        with span("gf.decode", codeword._data if isinstance(codeword, FieldArray) else None):
            return self._decode(codeword, erasures, output, errors)

    def _decode(self, codeword, erasures, output, errors):
        if output not in ("message", "codeword"):
            raise ValueError(f"Argument 'output' must be 'message' or 'codeword', not {output!r}.")
        codeword = self.field(codeword)
        is_1d = codeword.ndim == 1
        if codeword.ndim not in (1, 2):
            raise ValueError(f"Argument 'codeword' must be 1-D or 2-D, not {codeword.ndim}-D.")
        ns = codeword.shape[-1]
        if self.is_systematic:
            if not self.n - self.k + 1 <= ns <= self.n:
                raise ValueError(
                    f"Argument 'codeword' must have last dimension in "
                    f"[{self.n - self.k + 1}, {self.n}] for a systematic code, not {ns}."
                )
        elif ns != self.n:
            raise ValueError(f"Argument 'codeword' must have last dimension {self.n}, not {ns}.")

        if erasures is not None:
            erasures = torch.as_tensor(erasures, device=codeword.device)
            if erasures.dtype != torch.bool or tuple(erasures.shape) != codeword.shape:
                raise ValueError(
                    "Argument 'erasures' must be a boolean mask with the codeword's shape."
                )

        c2 = codeword.reshape(1, ns) if is_1d else codeword
        e2 = None if erasures is None else erasures.reshape(1, ns) if is_1d else erasures
        dec_codeword, n_errors = self._decode_codeword(c2, e2)
        ks = self.k - (self.n - ns)

        if output == "message":
            out = self._convert_codeword_to_message(dec_codeword, ks)
        else:
            out = dec_codeword
        if is_1d:
            out = out[0]
            n_errors = np.int64(n_errors[0])
        if errors:
            return out, n_errors
        return out

    def _decode_codeword(self, codeword, erasures=None) -> Tuple[FieldArray, np.ndarray]:
        raise NotImplementedError

    def _convert_codeword_to_message(self, codeword, ks: int):
        if self.is_systematic:
            return codeword[:, :ks]
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Properties (reference: _linear.py:313-384)
    # ------------------------------------------------------------------

    @property
    def field(self):
        return self._field

    @property
    def n(self) -> int:
        return self._n

    @property
    def k(self) -> int:
        return self._k

    @property
    def d(self) -> int:
        return self._d

    @property
    def t(self) -> int:
        return (self.d - 1) // 2

    @property
    def G(self) -> FieldArray:
        return self._G

    @property
    def H(self) -> FieldArray:
        return self._H

    @property
    def is_systematic(self) -> bool:
        return self._is_systematic


def generator_to_parity_check_matrix(G: FieldArray) -> FieldArray:
    """G = [I | P] -> H = [-P^T | I] (reference: _linear.py:387-426)."""
    field = type(G)
    k, n = G.shape
    if not np.array_equal(np.asarray(G, dtype=object)[:, :k], np.eye(k, dtype=np.int64)):
        raise ValueError("Argument 'G' must be in systematic form [I | P].")
    negPT = -(G[:, k:].T)
    H = np.concatenate(
        [np.asarray(negPT, dtype=object), np.eye(n - k, dtype=np.int64).astype(object)], axis=1
    )
    return field(H, device=G.device)


def parity_check_to_generator_matrix(H: FieldArray) -> FieldArray:
    """H = [-P^T | I] -> G = [I | P] (reference: _linear.py:427-465)."""
    field = type(H)
    nk, n = H.shape
    k = n - nk
    if not np.array_equal(np.asarray(H, dtype=object)[:, k:], np.eye(nk, dtype=np.int64)):
        raise ValueError("Argument 'H' must be in systematic form [-P^T | I].")
    P = -(H[:, :k].T)
    G = np.concatenate([np.eye(k, dtype=np.int64).astype(object), np.asarray(P, dtype=object)], axis=1)
    return field(G, device=H.device)
