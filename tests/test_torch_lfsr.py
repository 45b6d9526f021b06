"""FLFSR, GLFSR and berlekamp_massey of the torch port against the JAX
package, and the plain versions of kernels K12 (the LFSR scan) and K13 (the
long Berlekamp-Massey scan) against Python-int references; K12's block form
(its matrices, their layout and prepared entries, and one block assembled
as the kernel assembles it) against the plain tick loop; K13's two forms
(GF(2)'s lookahead blocks on packed words, the other kinds' warp-0 steps,
zero-run batches and CTA-wide steps), modelled in Python ints, against the
plain scan and the JAX package's ``_bm_kernel``.

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
from galois_tpu.lfsr import _bm_kernel as jax_bm_kernel
from galois_tpu_torch.fields._hostfield import get_host_field
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.ops._lfsr_scan import (
    BLOCK_TICKS,
    BM_S,
    _BINTAB,
    _ODDTAB,
    _field,
    _scan_tables,
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


# ----------------------------------------------------------------------
# K13's forms, modelled in Python ints as csrc/lfsr.cu computes them
# ----------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _fsr(lo, hi, sh):  # __funnelshift_r
    return (((hi << 32) | lo) >> (sh & 31)) & _M32


def _fsl(lo, hi, sh):  # __funnelshift_l
    return ((((hi << 32) | lo) << (sh & 31)) >> 32) & _M32


def _parity(x):
    return bin(x).count("1") & 1


def _gf2_block_scan(seq, S=BM_S):
    """``bm_gf2_kernel`` in Python ints: the sequence reversed as bits after
    one zero word, c and b (and two spares) as 32-bit words; a block of S
    steps is (1) the dots of c and of x^m b at t0 .. t0 + S - 1 as two words,
    each word of c AND-ed with the window funnel-shifted to each step, (2) the
    S scalar steps on the 2 x 2 matrix rows (u, v) and (w, z) as 32-bit
    polynomials, (3) c' = u c + v x^m b and, where L grew, b' = ug c + vg x^m b
    as carry-less products by each set bit. Returns (c as N + 1 bits, L)."""
    N = len(seq)
    cw, rw, last = (N + 32) >> 5, ((N + 31) >> 5) + 2, N >> 5
    last_mask = _M32 if (N & 31) == 31 else (2 << (N & 31)) - 1
    buf = [0] * (4 * cw)
    buf[0] = buf[cw] = 1
    Rp = [0] + [sum((int(seq[N - 1 - 32 * r - k]) & 1) << k for k in range(32) if N - 1 - 32 * r - k >= 0)
                for r in range(rw - 1)]

    def dots(off, top, o):  # bit k: the dot at t0 + k, of the words 0..top at R-offset o
        acc = [0] * S
        for w in range(top + 1):
            p0 = o + 32 * w + 1
            i0, sh = p0 >> 5, p0 & 31
            a, b, e = (Rp[i] if i < rw else 0 for i in (i0, i0 + 1, i0 + 2))
            lo, hi = _fsr(a, b, sh), _fsr(b, e, sh)
            for k in range(S):
                acc[k] ^= buf[off + w] & _fsr(lo, hi, S - 1 - k)
        return sum(_parity(acc[k]) << k for k in range(S))

    def clmul(u, lo, hi):
        r = 0
        for i in range(32):
            if (u >> i) & 1:
                r ^= _fsl(lo, hi, i)
        return r

    oc, ob, s1, s2 = 0, cw, 2 * cw, 3 * cw
    L, m, ext_c, ext_b = 0, 1, 0, 0
    for t0 in range(0, N, S):
        n = min(S, N - t0)
        rdc = int(f"{dots(oc, ext_c >> 5, N - 1 - t0):032b}"[::-1], 2)  # __brev
        rdb = int(f"{dots(ob, ext_b >> 5, N - 1 - t0 + m):032b}"[::-1], 2)
        u, v, w, z, ug, vg, kg = 1, 0, 0, 1, 0, 0, -1
        for k in range(n):
            sh = S - 1 - k
            if _parity((u & (rdc >> sh)) ^ (v & (rdb >> sh))):
                if 2 * L <= t0 + k:
                    ug, vg = u, v
                    u, v = u ^ w, v ^ z
                    w, z = (ug << 1) & _M32, (vg << 1) & _M32
                    L, kg = t0 + k + 1 - L, k
                    continue
                u, v = u ^ w, v ^ z
            w, z = (w << 1) & _M32, (z << 1) & _M32
        q, r = m >> 5, m & 31
        nc = max(ext_c + u.bit_length() - 1, m + ext_b + v.bit_length() - 1 if v else 0)
        nb = ext_b if kg < 0 else max(ext_c + ug.bit_length() - 1, m + ext_b + vg.bit_length() - 1 if vg else 0)
        nc, nb = min(nc, N), min(nb, N)
        new = []
        for j in range(max(nc, nb) // 32 + 1):
            c0, c1 = buf[oc + j], buf[oc + j - 1] if j else 0
            b0 = buf[ob + j - q] if j >= q else 0
            b1 = buf[ob + j - q - 1] if j > q else 0
            b2 = buf[ob + j - q - 2] if j > q + 1 else 0
            B0, B1 = _fsl(b1, b0, r), _fsl(b2, b1, r)
            if j <= nc >> 5:
                x = clmul(u, c1, c0) ^ clmul(v, B1, B0)
                new.append((s1 + j, x & last_mask if j == last else x))
            if kg >= 0 and j <= nb >> 5:
                x = clmul(ug, c1, c0) ^ clmul(vg, B1, B0)
                new.append((s2 + j, x & last_mask if j == last else x))
        for i, x in new:
            buf[i] = x
        oc, s1 = s1, oc
        if kg >= 0:
            ob, s2 = s2, ob
            m = n - kg
        else:
            m += n
        ext_c, ext_b = nc, nb
    return [(buf[oc + (j >> 5)] >> (j & 31)) & 1 for j in range(N + 1)], L


def _general_scan(Ft, seq, narrow, S=BM_S, U=4):
    """``bm_long_kernel`` in Python ints: the sequence staged reversed (LOG
    form, 0 as 2 (q - 1), for the table kinds), c, b and the spare as offsets
    of one buffer; warp 0 (stride 32) runs the steps while c spans fewer than
    32 narrow elements, after a step with d = 0 as batches of S dots of the
    same c (a lane's partials transposed, lane k summing step t + k's), then
    the CTA (``launch_bm``'s thread count) one step at a time. Each thread
    reads and writes only its own elements (asserted), BM_CHUNK (U) at a time.
    Returns (c, L)."""
    ops = get_ops(Ft._meta, Ft._mode)
    kind, F = _field(ops, "cpu")
    hf = get_host_field(Ft._meta)
    if kind in (_BINTAB, _ODDTAB):
        exp, log = (t.tolist() for t in _scan_tables(Ft._meta, "cpu"))

        def prep(a):
            return log[a] if a else F.sent

        def mulp(x, y):
            return exp[x + y]
    else:
        def prep(a):
            return a

        mulp = hf.multiply
    N, K = len(seq), len(seq) + 1
    buf = [1] + [0] * N + [1] + [0] * (2 * N + 1)
    rs = [prep(int(seq[N - 1 - i])) for i in range(N)]
    st = {"c": 0, "b": K, "s": 2 * K, "t": 0, "L": 0, "m": 1, "ext_c": 0, "ext_b": 0, "inv_b": 1}
    threads = 256
    while N + 1 > 32 * narrow and threads < 512 and threads * 8 < N + 1:
        threads *= 2

    def dot(stride):
        t, c = st["t"], st["c"]
        top = min(st["ext_c"], t)
        total = 0
        for tid in range(stride):
            acc = 0
            for j in range(tid, top + 1, U * stride):
                for k in range(j, j + U * stride, stride):
                    assert k % stride == tid
                    cv, rv = (buf[c + k], rs[N - 1 - t + k]) if k <= top else (0, prep(0))
                    acc = hf.add(acc, mulp(prep(cv), rv))
            total = hf.add(total, acc)
        return total

    def advance(d, stride):
        t = st["t"]
        st["t"] += 1
        if d == 0:
            st["m"] += 1
            return
        m, c, b = st["m"], st["c"], st["b"]
        grow = 2 * st["L"] <= t
        nxt = min(max(st["ext_c"], m + st["ext_b"]), N)
        hi = nxt if grow else min(m + st["ext_b"], N)
        dst = st["s"] if grow else c
        pc = prep(hf.multiply(d, st["inv_b"]))
        j0 = 0 if grow else m
        for tid in range(stride):
            for k in range(j0 + ((tid - j0) & (stride - 1)), hi + 1, stride):
                assert k % stride == tid
                bv = buf[b + k - m] if k >= m else 0
                buf[dst + k] = hf.subtract(buf[c + k], mulp(pc, prep(bv)))
        if grow:
            st["b"], st["c"], st["s"] = c, st["s"], b
            st["ext_b"], st["inv_b"], st["L"], st["m"] = st["ext_c"], hf.reciprocal(d), t + 1 - st["L"], 1
        else:
            st["m"] += 1
        st["ext_c"] = nxt

    def batch(nb):
        t, c = st["t"], st["c"]
        top = min(st["ext_c"], t + nb - 1)
        rows = [[0] * 32 for _ in range(S)]  # the transpose: row k, lane l
        for lane in range(32):
            for j in range(lane, top + 1, 32):
                cj = prep(buf[c + j])
                for k in range(S):
                    rv = rs[N - 1 - t + j - k] if k < nb and j <= t + k else prep(0)
                    rows[k][lane] = hf.add(rows[k][lane], mulp(cj, rv))
        return [functools.reduce(hf.add, row, 0) for row in rows]

    run = False
    while st["t"] < N and st["ext_c"] < 32 * narrow:
        if run:
            nb = min(S, N - st["t"])
            dk = batch(nb)
            nz = [k for k in range(nb) if dk[k]]
            if not nz:
                st["t"] += nb
                st["m"] += nb
                continue
            st["t"] += nz[0]
            st["m"] += nz[0]
            d = dk[nz[0]]
        else:
            d = dot(32)
        run = d == 0
        advance(d, 32)
    while st["t"] < N:
        advance(dot(threads), threads)
    return buf[st["c"] : st["c"] + K], st["L"]


@functools.lru_cache(maxsize=None)
def _bm_sequences(q, N=600):
    """K13's edge cases over GF(q), N elements: random (complexity near N / 2),
    a degree-12 LFSR's output (runs of d = 0), that output then random
    elements (L changes inside a block), the impulse (L = N), all zeros."""
    rng = np.random.default_rng(q % 1009)
    hi = min(q, 2**31)
    coeffs = [1] + [int(v) for v in rng.integers(0, hi, 11)] + [1]
    Fj = gj.GF(q)
    lf = np.asarray(gj.FLFSR(gj.Poly(coeffs, field=Fj), state=[int(v) for v in rng.integers(1, hi, 12)]).step(N),
                    dtype=np.int64)
    return {
        "random": rng.integers(0, hi, N),
        "lfsr": lf,
        "lfsr-then-random": np.concatenate([lf[: N * 11 // 20], rng.integers(0, hi, N - N * 11 // 20)]),
        "impulse": np.array([0] * (N - 1) + [1]),
        "zeros": np.zeros(N, dtype=np.int64),
    }


def _plain_and_jax(q, seq):
    """(c, L) of the port's plain scan and of the JAX package's ``_bm_kernel``."""
    Ft, Fj = gt.GF(q), gj.GF(q)
    c, L = berlekamp_massey_long_plain(get_ops(Ft._meta, Ft._mode), Ft(seq)._data)
    cj, Lj = jax_bm_kernel(Fj._meta, "jit-calculate", len(seq))(Fj(seq)._data)
    return (c.tolist(), int(L)), (np.asarray(cj, dtype=np.int64).tolist(), int(Lj))


BM_CASES = ["random", "lfsr", "lfsr-then-random", "impulse", "zeros"]


@pytest.mark.parametrize("case", BM_CASES + ["N=33", "N=65"])
def test_k13_gf2_block_model_matches_plain_and_jax(case):
    """GF(2): the kernel's lookahead blocks of 32 steps on packed words equal
    the plain scan and the JAX package's scan, N = 600 (not a multiple of 32)
    and at the word edges 33 and 65."""
    if case.startswith("N="):
        seq = np.random.default_rng(int(case[2:])).integers(0, 2, int(case[2:]))
    else:
        seq = _bm_sequences(2)[case]
    got = _gf2_block_scan([int(v) for v in seq])
    plain, jax_result = _plain_and_jax(2, seq)
    assert got == plain == jax_result


@pytest.mark.parametrize("case", BM_CASES)
@pytest.mark.parametrize("q", [2**8, 3**5, 2**31 - 1, 2**17], ids=["GF(2^8)", "GF(3^5)", "GF(2^31-1)", "GF(2^17)"])
def test_k13_general_model_matches_plain_and_jax(q, case):
    """The other kinds (BINTAB, ODDTAB, PRIME, BINARY): warp 0's steps and
    zero-run batches, then the CTA's, equal the plain scan and the JAX
    package's scan, N = 400 (not a multiple of 32); narrow 1 switches to the
    CTA at 32 elements, narrow 8 (the kernel's BM_NARROW) at 256."""
    seq = _bm_sequences(q, 400)[case]
    plain, jax_result = _plain_and_jax(q, seq)
    assert plain == jax_result
    for narrow in (1, 8):
        assert _general_scan(gt.GF(q), seq, narrow) == plain
