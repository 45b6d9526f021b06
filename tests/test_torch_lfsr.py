"""FLFSR, GLFSR and berlekamp_massey of the torch port against the JAX
package, and the plain versions of kernels K12 (the LFSR scan) and K13 (the
long Berlekamp-Massey scan) against Python-int references; K12's block form
(its matrices, their layout and prepared entries, and one block assembled
as the kernel assembles it) against the plain tick loop.

The same seeded characteristic polynomials and states go to both packages
over GF(2), GF(3), GF(2^3), GF(3^3), GF(2^8), GF(2^31 - 1), Goldilocks and
GF(2^100) (the JAX suite's own degree-4 polynomial); outputs, states, taps,
polynomials, strings and messages must be equal. ``berlekamp_massey`` is
held on both of its routes: the host loop (below 512 elements) and the
device scan (520 elements, and the JAX suite's high-complexity impulse).
"""

import functools

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field as jax_host_field
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops._lfsr_scan import (
    BLOCK_TICKS,
    berlekamp_massey_long,
    berlekamp_massey_long_plain,
    block_inputs,
    block_layout,
    block_matrices,
    lfsr_step,
    lfsr_step_plain,
    scan_supports,
)
from galois_tpu_torch.ops._linalg import _field_reduce
from galois_tpu_torch.ops._lookup import field_tables

ORDERS = [2, 3, 2**3, 3**3, 2**8, 2**31 - 1, 2**64 - 2**32 + 1, 2**100]
IDS = ["GF(2)", "GF(3)", "GF(2^3)", "GF(3^3)", "GF(2^8)", "GF(2^31-1)", "Goldilocks", "GF(2^100)"]
GF2_100_POLY = (
    "x^4 + 414029366129716807589746234643x^3 + 713840634647528950143955598853x^2 + "
    "178965232760409569156590479285x + 574717025925479275195710910921"
)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """The plain versions on the CPU, with one torch thread: the tensors hold
    a few elements, and other test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with gt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


def _eq(a, b):
    return np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


@functools.lru_cache(maxsize=None)
def _setup(q):
    """(port field, JAX field, characteristic poly coefficients, state): a
    degree-4 c(x) with a nonzero constant term, so that both directions run."""
    Ft, Fj = gt.GF(q), gj.GF(q)
    if q == 2**100:
        coeffs = [int(v) for v in np.asarray(gj.Poly.Str(GF2_100_POLY, field=Fj).coefficients(), dtype=object)]
    else:
        rng = np.random.default_rng(q % 1000)
        coeffs = [1] + [int(v) % q for v in rng.integers(0, 2**62, 3)] + [max(1, int(rng.integers(0, 2**62)) % q)]
    state = [1, 2 % q, 3 % q, 1]
    return Ft, Fj, tuple(coeffs), tuple(state)


@pytest.mark.parametrize("q", ORDERS, ids=IDS)
def test_lfsr_matches_jax(q):
    Ft, Fj, coeffs, state = _setup(q)
    ct, cj = gt.Poly(list(coeffs), field=Ft), gj.Poly(list(coeffs), field=Fj)
    ft, fj = gt.FLFSR(ct.reverse(), state=list(state)), gj.FLFSR(cj.reverse(), state=list(state))
    assert _eq(ft.taps, fj.taps) and ft.order == fj.order == 4
    assert str(ft) == str(fj) and repr(ft) == repr(fj)
    assert str(ft.characteristic_poly) == str(fj.characteristic_poly)
    assert _eq(ft.step(12), fj.step(12)) and _eq(ft.state, fj.state)
    assert _eq(ft.step(-12), fj.step(-12)) and _eq(ft.state, ft.initial_state)
    one_t, one_j = ft.step(1), fj.step(1)
    assert one_t.ndim == 0 and int(one_t) == int(one_j)
    assert ft.step(0).shape == (0,)
    gt_, gj_ = ft.to_galois_lfsr(), fj.to_galois_lfsr()
    assert _eq(gt_.state, gj_.state) and _eq(gt_.taps, gj_.taps)
    assert str(gt_) == str(gj_) and repr(gt_) == repr(gj_)
    assert _eq(gt_.step(12), gj_.step(12)) and _eq(gt_.state, gj_.state)
    assert _eq(gt_.step(-12), gj_.step(-12)) and _eq(gt_.state, gj_.state)
    back_t, back_j = gt_.to_fibonacci_lfsr(), gj_.to_fibonacci_lfsr()
    assert _eq(back_t.state, back_j.state)
    ft.reset()
    assert _eq(ft.state, ft.initial_state)
    ft.reset(list(state)[::-1])
    assert _eq(ft.state, list(state)[::-1])


@pytest.mark.parametrize("q", [7, 2**8], ids=["GF(7)", "GF(2^8)"])
def test_taps_and_errors_match_jax(q):
    Ft, Fj = gt.GF(q), gj.GF(q)
    T = [1, 2, 3, 4]
    for cls_t, cls_j in ((gt.FLFSR, gj.FLFSR), (gt.GLFSR, gj.GLFSR)):
        lt, lj = cls_t.Taps(Ft(T)), cls_j.Taps(Fj(T))
        assert str(lt.feedback_poly) == str(lj.feedback_poly) and _eq(lt.taps, lj.taps)
        assert repr(lt) == repr(lj)

    def message(fn, pkg):
        with pytest.raises(Exception) as info:
            fn(pkg)
        return type(info.value), str(info.value)

    cases = [
        lambda g: g.FLFSR([1, 2, 3]),
        lambda g: g.FLFSR(g.Poly([1, 0, 2], field=g.GF(q))),
        lambda g: g.GLFSR(g.Poly([1, 1, 1], field=g.GF(q)), state=[1, 2, 3]),
        lambda g: g.FLFSR.Taps([1, 2]),
        lambda g: g.berlekamp_massey([1, 2, 3]),
        lambda g: g.berlekamp_massey(g.GF(q)([[1, 2]])),
        lambda g: g.berlekamp_massey(g.GF(q)([1, 2]), output="bogus"),
    ]
    for fn in cases:
        assert message(fn, gt) == message(fn, gj)


@pytest.mark.parametrize("q", [2, 2**8, 2**31 - 1], ids=["GF(2)", "GF(2^8)", "GF(2^31-1)"])
def test_berlekamp_massey_matches_jax(q):
    Ft, Fj = gt.GF(q), gj.GF(q)
    rng = np.random.default_rng(q % 997)
    deg = 9
    coeffs = [1] + [int(v) for v in rng.integers(0, min(q, 2**62), deg - 1)] + [1]
    st = [int(v) for v in rng.integers(1, min(q, 2**62), deg)]
    seq_j = gj.FLFSR(gj.Poly(coeffs, field=Fj), state=st).step(520)
    seq_t = Ft(np.asarray(seq_j, dtype=np.int64))
    # the host loop (40 elements) in every output form, the device scan (520) in the last
    for seq_len, outs in ((40, ("characteristic", "connection", "fibonacci", "galois")), (520, ("galois",))):
        for out in outs:
            lt = gt.berlekamp_massey(seq_t[:seq_len], output=out)
            lj = gj.berlekamp_massey(seq_j[:seq_len], output=out)
            assert type(lt).__name__ == type(lj).__name__ and str(lt) == str(lj)
    # a random sequence: high linear complexity, a minimal LFSR that is not unique
    rnd = rng.integers(0, min(q, 256), 520)
    assert str(gt.berlekamp_massey(Ft(rnd))) == str(gj.berlekamp_massey(Fj(rnd)))


def test_berlekamp_massey_high_complexity_matches_jax():
    seq = [0] * 511 + [1]
    ct = gt.berlekamp_massey(gt.GF(2)(seq), output="connection")
    cj = gj.berlekamp_massey(gj.GF(2)(seq), output="connection")
    assert ct.degree == 512 and str(ct) == str(cj)


def test_berlekamp_massey_on_limbs_and_digits():
    """Limb and digit fields take the host loop, as in the JAX package."""
    for q in (2**100, 3**30):
        Ft, Fj = gt.GF(q), gj.GF(q)
        rng = np.random.default_rng(7)
        coeffs = [1] + [int(v) for v in rng.integers(1, 2**40, 3)]
        seq_j = gj.GLFSR(gj.Poly(coeffs, field=Fj).reverse(), state=[1, 2, 3]).step(10)
        seq_t = Ft(np.asarray(seq_j, dtype=object))
        assert str(gt.berlekamp_massey(seq_t)) == str(gj.berlekamp_massey(seq_j))


# ----------------------------------------------------------------------
# K12's and K13's plain versions against Python ints
# ----------------------------------------------------------------------

def _py_ticks(hf, state, taps, n, kind, direction):
    """The four tick functions in Python ints (galois_tpu/lfsr.py:63-106)."""
    s, out = list(state), []
    k = len(s)
    for _ in range(n):
        if (kind, direction) == ("fibonacci", "forward"):
            f = 0
            for a, b in zip(s, taps):
                f = hf.add(f, hf.multiply(a, b))
            out.append(s[-1])
            s = [f] + s[:-1]
        elif (kind, direction) == ("fibonacci", "backward"):
            v = s[0]
            for a, b in zip(s[1:], taps[:-1]):
                v = hf.subtract(v, hf.multiply(a, b))
            v = hf.multiply(v, hf.reciprocal(taps[-1]))
            out.append(v)
            s = s[1:] + [v]
        elif (kind, direction) == ("galois", "forward"):
            f = s[-1]
            out.append(f)
            s = [hf.add(a, hf.multiply(f, b)) for a, b in zip([0] + s[:-1], taps)]
        else:
            f = hf.multiply(s[0], hf.reciprocal(taps[0]))
            out.append(f)
            s = [hf.subtract(a, hf.multiply(f, b)) for a, b in zip(s[1:], taps[1:])] + [f]
    assert len(s) == k
    return s, out


def _py_bm(hf, seq):
    """The JAX package's scan recurrence in Python ints, capacity N + 1."""
    N = len(seq)
    K = N + 1
    c, b = [1] + [0] * N, [1] + [0] * N
    L, m, bcoef = 0, 1, 1
    for t in range(N):
        d = 0
        for i in range(min(t, K - 1) + 1):
            d = hf.add(d, hf.multiply(c[i], seq[t - i]))
        if d == 0:
            m += 1
            continue
        coef = hf.multiply(d, hf.reciprocal(bcoef))
        c_new = [hf.subtract(c[i], hf.multiply(coef, b[i - m])) if i >= m else c[i] for i in range(K)]
        if 2 * L <= t:
            b, bcoef, L, m = c, d, t + 1 - L, 1
        else:
            m += 1
        c = c_new
    return c, L


@pytest.mark.parametrize("q", [2, 2**8, 3**3, 2**31 - 1, 2**100], ids=["GF(2)", "GF(2^8)", "GF(3^3)", "GF(2^31-1)", "GF(2^100)"])
@pytest.mark.parametrize("kind", ["fibonacci", "galois"])
def test_k12_plain_against_python_ints(q, kind):
    Ft = gt.GF(q)
    ops = get_ops(Ft._meta, Ft._mode)
    hf = jax_host_field(gj.GF(q)._meta)
    rng = np.random.default_rng(3)
    k = 5
    state = [int(v) % q for v in rng.integers(0, 2**62, k)]
    taps = [max(1, int(v) % q) for v in rng.integers(0, 2**62, k)]
    st, tp = Ft(state)._data, Ft(taps)._data
    end = k - 1 if kind == "fibonacci" else 0
    for direction in ("forward", "backward"):
        want_s, want_y = _py_ticks(hf, state, taps, 9, kind, direction)
        if scan_supports(Ft._meta):  # through the wrapper: its plain version on the CPU
            inv = hf.reciprocal(taps[end])
            s, y = lfsr_step(ops, st, tp, 9, kind, direction, inv)
        else:
            inv = ops.reciprocal(tp.narrow(1, end, 1))
            s, y = lfsr_step_plain(ops, st, tp, 9, kind, direction, inv)
        assert _eq(Ft._view(s), want_s) and _eq(Ft._view(y), want_y)


@pytest.mark.parametrize("q", [2, 2**8, 3**3, 2**31 - 1], ids=["GF(2)", "GF(2^8)", "GF(3^3)", "GF(2^31-1)"])
def test_k13_plain_against_python_ints(q):
    Ft = gt.GF(q)
    ops = get_ops(Ft._meta, Ft._mode)
    hf = jax_host_field(gj.GF(q)._meta)
    rng = np.random.default_rng(4)
    for seq in ([int(v) for v in rng.integers(0, min(q, 2**31), 40)], [0] * 30 + [1], [0] * 12):
        c, L = berlekamp_massey_long(ops, Ft(seq)._data)
        c_plain, L_plain = berlekamp_massey_long_plain(ops, Ft(seq)._data)
        want_c, want_L = _py_bm(hf, seq)
        assert int(L) == int(L_plain) == want_L
        assert _eq(Ft._view(c), want_c) and torch.equal(c, c_plain)


# ----------------------------------------------------------------------
# K12's block form: the host's matrices, as the kernel uses them
# ----------------------------------------------------------------------

def _matvec(ops, M, s):
    """The field product of a matrix (r, c) and a vector (c,) in storage."""
    return _field_reduce(ops.add, ops.multiply(M, s.unsqueeze(0)), 1)


def _block_by_layout(ops, lay, s, k, threads, rows_first, col0=0):
    """The kernel's step 1 from a layout of ``block_layout``: thread tid's
    sum of its entries times the state elements it reads; D's partial sums
    then summed over the warps (one value a lane), G's one a thread."""
    r = torch.arange(BLOCK_TICKS).unsqueeze(1)
    tid = torch.arange(threads).unsqueeze(0)
    idx = (tid // 32 + (threads // 32) * r) if rows_first else (col0 + r).expand(-1, threads)
    ok = idx < (k if rows_first else col0 + min(BLOCK_TICKS, k))
    prod = ops.multiply(lay.to(s.dtype), s[idx.clamp(max=k - 1)])
    part = _field_reduce(ops.add, torch.where(ok, prod, torch.zeros_like(prod)), 0)
    if rows_first:
        return _field_reduce(ops.add, part.reshape(threads // 32, 32), 0)
    return part[:k]


@pytest.mark.parametrize("k", [5, 32, 40], ids=["k<B", "k=B", "k>B"])
@pytest.mark.parametrize("q", [2, 2**8, 3**5, 2**31 - 1], ids=["GF(2)", "GF(2^8)", "GF(3^5)", "GF(2^31-1)"])
def test_k12_block_matrices_match_ticks(q, k):
    """B ticks of the plain loop equal Y s and P s (``block_matrices`` on
    the identity); one block assembled from D and G as csrc/lfsr.cu does
    (the outputs, the shifted state and the new elements), and the sums of
    D's and G's kernel layouts, equal them too; the prepared entries are
    the values (or their LOG, 2 (q - 1) for 0, for the table kinds)."""
    Ft = gt.GF(q)
    ops = get_ops(Ft._meta, Ft._mode)
    hf = jax_host_field(gj.GF(q)._meta)
    rng = np.random.default_rng(k + q % 1000)
    B = BLOCK_TICKS
    st = Ft(rng.integers(0, q, k))._data
    tp = Ft(rng.integers(1, q, k))._data
    threads = -(-k // 32) * 32
    for kind in ("fibonacci", "galois"):
        end = k - 1 if kind == "fibonacci" else 0
        inv = hf.reciprocal(int(tp[end]))
        inv_t = torch.full((1,), inv, dtype=st.dtype)
        for direction in ("forward", "backward"):
            D, G, P, Y = block_matrices(ops, tp, kind, direction, inv_t)
            s_ref, y_ref = lfsr_step_plain(ops, st, tp, B, kind, direction, inv_t)
            assert torch.equal(_matvec(ops, Y, st), y_ref) and torch.equal(_matvec(ops, P, st), s_ref)
            d = _matvec(ops, D, st)
            assert torch.equal(_block_by_layout(ops, block_layout(D, threads, True), st, k, threads, True), d)
            zero = torch.zeros((), dtype=st.dtype)
            if (kind, direction) == ("fibonacci", "forward"):
                y = torch.stack([st[k - 1 - j] if j < k else d[j - k] for j in range(B)])
                s_new = torch.stack([d[B - 1 - i] if i < B else st[i - B] for i in range(k)])
            elif kind == "fibonacci":
                y = d
                s_new = torch.stack([st[i + B] if i + B < k else d[i - (k - B)] for i in range(k)])
            else:
                cw = min(B, k)
                col0 = k - cw if direction == "forward" else 0
                g = _matvec(ops, G, st[col0 : col0 + cw])
                lay = block_layout(G, threads, False)
                assert torch.equal(_block_by_layout(ops, lay, st, k, threads, False, col0), g)
                src = [i - B if direction == "forward" else i + B for i in range(k)]
                shifted = torch.stack([st[j] if 0 <= j < k else zero for j in src])
                y, s_new = d, ops.add(shifted, g)
            assert torch.equal(y, y_ref) and torch.equal(s_new, s_ref), (kind, direction)
            # the kernel's prepared layouts
            Dk, Gk = block_inputs(ops, D, G, k)
            raw = block_layout(D, threads, True)
            inside = block_layout(torch.ones_like(D), threads, True) == 1  # the rest is padding, 0, never read
            prep = Dk.to(torch.int64) & 0xFFFFFFFF
            assert not prep[~inside].any()
            if Ft._meta.degree > 1:
                exp_t = field_tables(Ft._meta, "cpu")[0].to(torch.int64)
                nz = inside & (raw != 0)
                assert torch.equal(exp_t[prep[nz]], raw[nz])
                assert bool((prep[inside & (raw == 0)] == 2 * (q - 1)).all())
            else:
                assert torch.equal(prep, raw)
            assert (Gk is None) == (kind == "fibonacci")


def _packed_gf2_blocks(Dk, Gk, st, k, kind, direction, nblk):
    """csrc/lfsr.cu's GF(2) block form for k <= 32 in Python ints: the state
    as one word (bit j: element j), lane l's row of D (and of G) as a mask of
    its layout's low bits; each block one popc parity a lane, gathered by a
    ballot into a word. Returns (state, outputs) as int lists."""
    B = BLOCK_TICKS
    kmask = (1 << k) - 1
    dm = [sum((int(Dk[r, lane]) & 1) << r for r in range(B)) for lane in range(B)]
    gm = [sum((int(Gk[r, lane]) & 1) << r for r in range(B)) for lane in range(B)] if Gk is not None else None

    def ballot(bits):
        return sum(b << lane for lane, b in enumerate(bits))

    S = ballot([int(v) & 1 for v in st]) & kmask
    out = []
    for _ in range(nblk):
        A = ballot([bin(dm[lane] & S).count("1") & 1 for lane in range(B)])
        if (kind, direction) == ("fibonacci", "forward"):
            out += [(S >> (k - 1 - lane)) & 1 if lane < k else (A >> (lane - k)) & 1 for lane in range(B)]
            S = int(f"{A:032b}"[::-1], 2) & kmask  # __brev
        elif kind == "fibonacci":
            out += [(A >> lane) & 1 for lane in range(B)]
            S = (A >> (B - k)) & kmask
        else:
            out += [(A >> lane) & 1 for lane in range(B)]
            S = ballot([bin(gm[lane] & S).count("1") & 1 for lane in range(B)]) & kmask
    return [(S >> i) & 1 for i in range(k)], out


@pytest.mark.parametrize("k", [1, 7, 20, 31, 32])
@pytest.mark.parametrize(["kind", "direction"], [("fibonacci", "forward"), ("fibonacci", "backward"),
                                                 ("galois", "forward"), ("galois", "backward")])
def test_k12_gf2_packed_blocks_match_ticks(kind, direction, k):
    """GF(2) up to 32 taps: the kernel's packed block form (masks of D's and
    G's layouts, popc parities, ballots, a bit reversal for Fibonacci
    forward), modelled in Python ints, equals three blocks of the plain
    tick loop."""
    Ft = gt.GF(2)
    ops = get_ops(Ft._meta, Ft._mode)
    rng = np.random.default_rng(k)
    st = Ft(rng.integers(0, 2, k))._data
    tp = Ft(rng.integers(0, 2, k))._data
    tp[k - 1 if kind == "fibonacci" else 0] = 1  # the end tap, which a backward step divides by
    one = torch.ones(1, dtype=st.dtype)
    D, G, _, _ = block_matrices(ops, tp, kind, direction, one)
    Dk, Gk = block_inputs(ops, D, G, k)
    s_ref, y_ref = lfsr_step_plain(ops, st, tp, 3 * BLOCK_TICKS, kind, direction, one)
    s, y = _packed_gf2_blocks(Dk, Gk, st.tolist(), k, kind, direction, 3)
    assert s == s_ref.tolist() and y == y_ref.tolist()
