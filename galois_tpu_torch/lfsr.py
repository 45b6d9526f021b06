"""Linear-feedback shift registers and Berlekamp-Massey.

Port of ``galois_tpu/lfsr.py``: ``FLFSR``, ``GLFSR`` and
``berlekamp_massey`` with the same constructors, properties, conversions,
messages and results. An LFSR's state, taps and outputs live on one device:
its initial state's (a FieldArray or tensor keeps its own; host input goes
to the package's default device, CUDA unless the caller asks for the CPU).

Routes, by field (none falls back on a failure: a build or launch error
raises):

- ``step(n)``: fields that ``ops/_lfsr_scan.py::scan_supports`` names, int
  storage with GF(p), p < 2^32, GF(2^m), m <= 32, or GF(p^m), p odd,
  p^m <= 2^16, go to kernel K12 (``lfsr_step``) at every order: one launch
  for all n ticks on a CUDA register (and, up to 1024 taps, one more the
  first time a direction takes the block form: the register keeps its
  matrices), its plain tick loop on a CPU one.
  Every other field (GF(2^m), m > 32, on limbs, GF(p) above 2^32, the
  digit fields, odd p^m between 2^16 and 2^31) runs the plain torch tick
  loop on the register's device. The JAX package runs
  one ``lax.scan`` of n ticks for every field.
- ``berlekamp_massey``: int storage and a sequence of 512 or more elements
  take the device scan, as in the JAX package: kernel K13
  (``berlekamp_massey_long``) for the fields K12 takes, one launch on a
  CUDA sequence and the plain scan on a CPU one, and the plain scan on the
  sequence's device for the other int-storage fields; shorter sequences,
  the limb and digit fields and the 'python-calculate' mode take the host
  discrepancy loop in Python ints. In that mode ``step`` runs the default
  mode's route above.
"""

from __future__ import annotations

import numpy as np

from .fields._array import FieldArray
from .fields._hostfield import get_host_field
from .fields._meta import STORAGE_INT
from .ops._kernels import get_ops, kernel_mode
from .ops._limbs import _i16
from .ops._lfsr_scan import (
    berlekamp_massey_long,
    berlekamp_massey_long_plain,
    lfsr_step,
    lfsr_step_plain,
    scan_supports,
)
from .polys._poly import Poly, _int_array

__all__ = ["FLFSR", "GLFSR", "berlekamp_massey"]


class _LFSR:
    _kind = "fibonacci"

    def __init__(self, feedback_poly: Poly, state=None):
        if not isinstance(feedback_poly, Poly):
            raise TypeError(f"Argument 'feedback_poly' must be a Poly, not {type(feedback_poly)}.")
        if int(feedback_poly.coefficients()[-1]) != 1:
            raise ValueError(
                f"Argument 'feedback_poly' must have a 0-th degree term of 1, not {feedback_poly}."
            )
        self._field = feedback_poly.field
        self._feedback_poly = feedback_poly
        self._characteristic_poly = feedback_poly.reverse()
        self._order = feedback_poly.degree

        if state is None:
            state = self._field.Ones(self._order)
        self._initial_state = self._verify_state(state)
        self._state = self._initial_state.copy()

        # c(x) = x^n + a_1 x^(n-1) + ... + a_n; taps per the reference's
        # convention (src/galois/_lfsr.py:48-55), on the state's device
        c = np.asarray(self._characteristic_poly.coefficients(), dtype=object)
        hf = get_host_field(self._field._meta)
        taps = [hf.negative(int(v)) for v in c[1:]]
        if self._kind == "galois":
            taps = taps[::-1]
        self._taps_int = taps
        self._taps = self._field(_int_array(taps, self._field), device=self._state.device)
        self._blocks = {}  # K12's block form of these taps, per direction and device (lfsr_step's ``blocks``)

    @classmethod
    def Taps(cls, taps, state=None):
        if not isinstance(taps, FieldArray):
            raise TypeError(f"Argument 'taps' must be a FieldArray, not {type(taps)}.")
        field = type(taps)
        coeffs = np.concatenate([[1], np.asarray(-taps, dtype=object)])
        if cls._kind == "fibonacci":
            # f(x) = 1 + a_1 x + ... + a_n x^n
            feedback_poly = Poly(coeffs[::-1].tolist(), field=field)
        else:
            feedback_poly = Poly(coeffs.tolist(), field=field).reverse()
        return cls(feedback_poly, state=state)

    def _verify_state(self, state):
        s = self._field(state)
        if s.size != self._order:
            raise ValueError(f"Argument 'state' must have size {self._order}, not {s.size}.")
        return s.flatten()

    def reset(self, state=None):
        self._state = self._initial_state.copy() if state is None else self._verify_state(state)

    # -- properties --
    @property
    def field(self):
        return self._field

    @property
    def feedback_poly(self) -> Poly:
        return self._feedback_poly

    @property
    def characteristic_poly(self) -> Poly:
        return self._characteristic_poly

    @property
    def order(self) -> int:
        return self._order

    @property
    def taps(self):
        return self._taps

    @property
    def initial_state(self):
        return self._initial_state.copy()

    @property
    def state(self):
        return self._state.copy()

    # -- stepping --
    def step(self, steps: int = 1):
        """Clock the register ``steps`` times (backwards when negative) and
        return the outputs; a single step returns a 0-D array."""
        steps = int(steps)
        if steps == 0:
            return self._field([], device=self._state.device)
        direction = "forward" if steps > 0 else "backward"
        if direction == "backward" and int(self.characteristic_poly.coefficients()[-1]) == 0:
            # reference parity (src/galois/_lfsr.py:129-134)
            raise ValueError(
                "Can only step the shift register backwards if the a_n tap is "
                f"non-zero, not c(x) = {self.characteristic_poly}."
            )
        n = abs(steps)
        cls = self._field
        meta = cls._meta
        ops = get_ops(meta, kernel_mode(cls))
        state, taps = self._state._data, self._taps._data.to(self._state.device)
        end = self._order - 1 if self._kind == "fibonacci" else 0  # the tap a backward step divides by
        if scan_supports(meta):
            inv = get_host_field(meta).reciprocal(self._taps_int[end]) if direction == "backward" else 0
            new_state, y = lfsr_step(ops, state, taps, n, self._kind, direction, inv, self._blocks)
        else:
            ax = 1 if meta.storage_first else 0
            inv = ops.reciprocal(taps.narrow(ax, end, 1)) if direction == "backward" else None
            new_state, y = lfsr_step_plain(ops, state, taps, n, self._kind, direction, inv)
        self._state = cls._view(new_state, self._state._dtype)
        out = cls._view(y, self._state._dtype)
        if n == 1:
            out = out[0]  # reference parity: single steps return 0-D scalars
        return out

    def __repr__(self):
        from ._options import printoptions

        name = "Fibonacci" if self._kind == "fibonacci" else "Galois"
        with printoptions(coeffs="asc"):
            return f"<{name} LFSR: f(x) = {self.feedback_poly} over {self.field.name}>"

    def __str__(self):
        name = "Fibonacci" if self._kind == "fibonacci" else "Galois"
        lines = [
            f"{name} LFSR:",
            f"  field: {self.field.name}",
            f"  feedback_poly: {self.feedback_poly}",
            f"  characteristic_poly: {self.characteristic_poly}",
            f"  taps: {self.taps}",
            f"  order: {self.order}",
            f"  state: {self.state}",
            f"  initial_state: {self.initial_state}",
        ]
        return "\n".join(lines)


class FLFSR(_LFSR):
    """Fibonacci linear-feedback shift register
    (reference: src/galois/_lfsr.py:182)."""

    _kind = "fibonacci"

    def to_galois_lfsr(self) -> "GLFSR":
        """Equivalent Galois LFSR: G_0(x) = floor(Y(x) P(x) / x^n) where Y is
        the next-n-outputs polynomial (reference: src/galois/_lfsr.py:491)."""
        n = self.order
        state = np.asarray(self.state, dtype=object)
        Y = Poly(state[::-1].tolist(), field=self.field)
        G0 = (Y * self.characteristic_poly) // Poly.Degrees([n], field=self.field)
        g = np.asarray(G0.coefficients(n), dtype=object)[::-1]  # ascending g_0..g_{n-1}
        return GLFSR(self.feedback_poly, state=self.field(g, device=self._state.device))


class GLFSR(_LFSR):
    """Galois linear-feedback shift register
    (reference: src/galois/_lfsr.py:852)."""

    _kind = "galois"

    def to_fibonacci_lfsr(self) -> FLFSR:
        """Equivalent Fibonacci LFSR: its state is the next n outputs of this
        register, reversed (reference: src/galois/_lfsr.py:1159)."""
        clone = GLFSR(self.feedback_poly, state=self._state)
        y = clone.step(self.order)
        return FLFSR(self.feedback_poly, state=_reversed(y.reshape(self.order)))


def berlekamp_massey(sequence, output: str = "characteristic"):
    """Berlekamp-Massey: minimal LFSR of a linear recurrent sequence
    (reference: src/galois/_lfsr.py:1502-1619)."""
    if not isinstance(sequence, FieldArray):
        raise TypeError(f"Argument 'sequence' must be a FieldArray, not {type(sequence)}.")
    if sequence.ndim != 1:
        raise ValueError(f"Argument 'sequence' must be 1-D, not {sequence.ndim}-D.")
    if output not in ("characteristic", "connection", "fibonacci", "galois"):
        raise ValueError(
            f"Argument 'output' must be in ['characteristic', 'connection', 'fibonacci', 'galois'], not {output!r}."
        )
    field = type(sequence)
    meta = field._meta

    # Long sequences: one device scan instead of the O(N L) host loop, read
    # back once at the end.
    if meta.storage == STORAGE_INT and len(sequence) >= 512 and field._mode != "python-calculate":
        ops = get_ops(meta, kernel_mode(field))
        scan = berlekamp_massey_long if scan_supports(meta) else berlekamp_massey_long_plain
        c_dev, L_dev = scan(ops, sequence._data)
        L = int(L_dev)
        c = c_dev[: L + 1].cpu().numpy()
        if field.order == 2:  # the connection polynomial as GF(2)[x]'s packed int, bit i the x^i term
            packed = np.packbits(c.astype(np.uint8), bitorder="little").tobytes()
            return _bm_output(sequence, Poly._from_int2(int.from_bytes(packed, "little"), field), output)
        return _bm_output(sequence, Poly(c[::-1].astype(np.int64).tolist(), field=field), output)

    # Classic discrepancy/update form.
    hf = get_host_field(meta)
    seq = [int(v) for v in np.asarray(sequence, dtype=object)]
    N = len(seq)
    c = [1]  # connection poly, ascending
    b = [1]
    L, m = 0, 1
    bcoef = 1
    for t in range(N):
        d = seq[t]
        for i in range(1, L + 1):
            if i < len(c) and c[i]:
                d = hf.add(d, hf.multiply(c[i], seq[t - i]))
        if d == 0:
            m += 1
            continue
        temp = list(c)
        coef = hf.multiply(d, hf.reciprocal(bcoef))
        if len(b) + m > len(c):
            c = c + [0] * (len(b) + m - len(c))
        for i, bi in enumerate(b):
            if bi:
                c[i + m] = hf.subtract(c[i + m], hf.multiply(coef, bi))
        if 2 * L <= t:
            L = t + 1 - L
            b = temp
            bcoef = d
            m = 1
        else:
            m += 1

    return _bm_output(sequence, Poly(c[: L + 1][::-1], field=field), output)


def _bm_output(sequence, connection_poly, output):
    """Shared tail: the connection polynomial -> requested form."""
    if output == "characteristic":
        return connection_poly.reverse()
    if output == "connection":
        return connection_poly

    fib = FLFSR(connection_poly, state=_reversed(sequence[: connection_poly.degree]))
    if output == "fibonacci":
        return fib
    return fib.to_galois_lfsr()


def _reversed(x: FieldArray) -> FieldArray:
    """A 1-D array's elements in reverse order, on its device."""
    return type(x)._view(_i16(x._data).flip(-1).view(x._data.dtype), x._dtype)
