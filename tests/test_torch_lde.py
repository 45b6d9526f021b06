"""The Goldilocks low-degree extension through galois_tpu_torch's public NTT,
held to the plain reference ``portbench/reference/goldilocks_ntt.py``.

The reference's field arithmetic and transforms against Python-int
arithmetic and a naive DFT; the port's ``np.fft.fft(np.fft.ifft(x) * coset,
n=2N)`` against the reference's extension on seeded random columns, at
N = 64 (the inverse a direct DFT, the forward of 128 the limb 4-step) and
N = 2^12 (both the limb 4-step), exactly; the spans the extension records
under ``torch.profiler``. CPU, with one ``cuda`` test: every device
operation of an extension at 2^16 launches inside a ``gf.ntt`` span or the
coset product. This file imports neither jax nor galois_tpu.
"""

import math
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import galois_tpu_torch as gt
from galois_tpu_torch import _tracing
from portbench.reference import goldilocks_ntt as ref

P = ref.P
G = 7  # the multiplicative generator, and the coset's shift
NTT_SPANS = ["gf.ntt", "gf.ntt.twiddle", "gf.limb_matmul.products", "gf.limb_matmul.combine"]


@pytest.fixture(autouse=True)
def _on_cpu():
    """New data goes to CUDA by default; these tests ask for the CPU (the
    ``cuda`` test asks for the card inside), each with an empty record."""
    _tracing.clear()
    with gt.default_device("cpu"):
        yield
    _tracing.clear()


def _pair(values, device="cpu"):
    return (torch.tensor([v >> 32 for v in values], device=device),
            torch.tensor([v & (2**32 - 1) for v in values], device=device))


def _columns(C, n, seed, device="cpu"):
    """(hi, lo) of C seeded columns of n elements, the field's edges first."""
    rnd = random.Random(seed)
    vals = [rnd.randrange(P) for _ in range(C * n)]
    vals[:4] = [0, 1, P - 1, 2**32]
    hi, lo = _pair(vals, device)
    return hi.reshape(C, n), lo.reshape(C, n)


def _naive_dft(xs, w):
    n = len(xs)
    return [sum(x * pow(w, j * k, P) for j, x in enumerate(xs)) % P for k in range(n)]


EDGES = [0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, 2**64 - 2**32, 12345678901234567]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_reference_arithmetic_against_python_ints(op):
    rnd = random.Random(3)
    xs = EDGES + [rnd.randrange(P) for _ in range(2000)]
    ys = EDGES[::-1] + [rnd.randrange(P) for _ in range(2000)]
    want = {"mul": lambda x, y: x * y % P, "add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P}[op]
    got = ref.to_int(getattr(ref, op)(_pair(xs), _pair(ys)))
    assert got == [want(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [16, 64])
def test_reference_ntt_against_a_naive_dft(n, inverse):
    hi, lo = _columns(1, n, n)
    xs = ref.to_int((hi[0], lo[0]))
    w = pow(G, (P - 1) // n, P)
    if inverse:
        n_inv = pow(n, P - 2, P)
        want = [v * n_inv % P for v in _naive_dft(xs, pow(w, P - 2, P))]
    else:
        want = _naive_dft(xs, w)
    assert ref.to_int(ref.ntt((hi[0], lo[0]), G, inverse=inverse)) == want


def test_reference_lde_evaluates_the_interpolant_on_the_coset():
    """The guarantee itself: output k is the column's interpolant at
    shift * w_(2N)^k."""
    n = 16
    hi, lo = _columns(2, n, 5)
    out = ref.lde((hi, lo), G, G, 2)
    for c in range(2):
        xs = ref.to_int((hi[c], lo[c]))
        coeffs = [v * pow(n, P - 2, P) % P for v in _naive_dft(xs, pow(pow(G, (P - 1) // n, P), P - 2, P))]
        w2 = pow(G, (P - 1) // (2 * n), P)
        want = [sum(a * pow(G * pow(w2, k, P), j, P) for j, a in enumerate(coeffs)) % P for k in range(2 * n)]
        assert ref.to_int((out[0][c], out[1][c])) == want


@pytest.mark.parametrize("precision", ["float64", "float16", "float8_e4m3fn"])
def test_control_differs_from_the_exact_reference(precision):
    hi, lo = _columns(1, 64, 9)
    exact = ref.lde((hi, lo), G, G, 2)
    lossy = ref.lde((hi, lo), G, G, 2, butterfly_mul=ref.lossy_mul(precision))
    assert not torch.equal(exact[0], lossy[0]) or not torch.equal(exact[1], lossy[1])


@pytest.mark.parametrize("precision, bits", [("float64", 53), ("float32", 24), ("tfloat32", 11), ("bfloat16", 8),
                                             ("float16", 11), ("float8_e4m3fn", 4)])
def test_control_rounds_each_operand_to_the_significand(precision, bits):
    """The control's operands are the elements rounded to ``bits`` significant
    bits in float64's range (ties to even, as both ``torch.round`` and
    Python's ``round`` take them), then reduced mod p."""
    assert ref.significand_bits(precision) == bits
    rng = random.Random(bits)
    xs = [rng.randrange(P) for _ in range(500)] + [P - 1, 1, 2**64 - 2**32, 2**53 + 1]
    a = (torch.tensor([x >> 32 for x in xs]), torch.tensor([x & (2**32 - 1) for x in xs]))
    one = ref.from_int(1)
    got = ref.to_int(ref.lossy_mul(precision)(a, (one[0].expand(len(xs)), one[1].expand(len(xs)))))

    def rounded(x):
        m, e = math.frexp(float(x))
        return round(m * 2**bits) * 2 ** (e - bits) % P

    assert got == [rounded(x) for x in xs]
    with pytest.raises(ValueError):
        ref.significand_bits("int8")


def _port_lde(cols, n):
    F = gt.GF(P)
    x = F(ref.split_limbs(cols).to(torch.uint16))
    coset = F(G) ** np.arange(n)
    return np.fft.fft(np.fft.ifft(x) * coset, n=2 * n)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("n", [64, 2**12])
def test_port_lde_matches_the_reference(n, C):
    cols = _columns(C, n, 100 * n + C)
    y = _port_lde(cols, n)
    assert y.shape == (C, 2 * n)
    want = ref.split_limbs(ref.lde(cols, G, G, 2))
    assert torch.equal(y._data.to(torch.int64), want)


def test_no_profiler_no_ntt_spans():
    _port_lde(_columns(1, 2**12, 1), 2**12)
    assert _tracing.spans() == []


def test_lde_records_its_spans_under_the_profiler():
    """Two ``gf.ntt`` spans, outermost; the twiddle products (one a 4-step
    plan) and 1/N inside them, the limb matmuls' products and combines inside
    those; the profiler's own events carry the names as host ops; the result
    is the untraced one."""
    n = 2**12
    cols = _columns(1, n, 2)
    plain = _port_lde(cols, n)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _port_lde(cols, n)
    assert torch.equal(plain._data, traced._data)
    recs = _tracing.spans()
    top = [s for s in recs if s.parent is None]
    assert [s.name for s in top] == ["gf.ntt", "gf.ntt"]
    by_index = {s.index: s for s in recs}
    assert {s.name for s in recs} == set(NTT_SPANS)
    assert all(by_index[s.call].name == "gf.ntt" for s in recs)
    assert sum(s.name == "gf.ntt.twiddle" for s in recs) == 3  # two T products and the inverse's 1/N
    for name in ("gf.limb_matmul.products", "gf.limb_matmul.combine"):
        assert all(by_index[s.parent].name == "gf.ntt" for s in recs if s.name == name)
    assert all(s.device_ms is None for s in recs)  # no CUDA tensor to time
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert set(NTT_SPANS) <= names


@pytest.mark.cuda
def test_every_device_op_of_an_lde_launches_inside_a_span():
    """On the card, at 2^16 with 3 columns: the extension equals the
    reference, every span carries device time, and every device operation
    launched during the call was launched inside a ``gf.ntt`` span or the
    coset product (the launch found by its correlation id, on the
    profiler's host clock). No device event bears a span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    n = 2**16
    cols = _columns(3, n, 16, dev)
    with gt.default_device(dev):
        F = gt.GF(P)
        x = F(ref.split_limbs(cols).to(torch.uint16))
        coset = F(G) ** np.arange(n)
        np.fft.fft(np.fft.ifft(x) * coset, n=2 * n)  # plans and kernels, outside the record
        torch.cuda.synchronize()
        _tracing.clear()
        cpu = torch.autograd.DeviceType.CPU
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            coeffs = np.fft.ifft(x)
            with torch._C._profiler._RecordFunctionFast("lde.coset"):
                shifted = coeffs * coset
            y = np.fft.fft(shifted, n=2 * n)
            torch.cuda.synchronize()
    recs = _tracing.spans()
    assert {s.name for s in recs} == set(NTT_SPANS) and all(s.device_ms > 0 for s in recs)
    assert torch.equal(y._data.to(torch.int64), ref.split_limbs(ref.lde(cols, G, G, 2)))
    events = list(prof.profiler.kineto_results.events())
    host = [ev for ev in events if ev.device_type() == cpu]
    launch_at = {ev.correlation_id(): ev.start_ns() for ev in host if ev.name().startswith("cu")}
    within = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in host if ev.name() in ("gf.ntt", "lde.coset")]
    assert len(within) == 3
    launched = [(ev.name(), launch_at.get(ev.correlation_id(), -1)) for ev in events if ev.device_type() != cpu]
    assert len(launched) >= 19  # one limb matmul's diagonals alone
    assert [name for name, t in launched if not any(s0 <= t <= s1 for s0, s1 in within)] == []
    assert not [name for name, _ in launched if name.startswith("gf.")]
