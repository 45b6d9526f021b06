"""Kernels K8-A (the GF(2^m) power chain) and K8-B (the Berlekamp-Massey
scan) of the torch port, through their plain versions on the CPU.

- ``gf2m_power_plain`` against the JAX package's ``BinaryExtOps.reciprocal``
  and ``power`` for m = 2..16, with the field's default and a second
  irreducible f: every element for m <= 12, 4099 random ones above; the
  exponents 0, 1, 2, 2^m - 2, 2^m - 1, random and broadcast.
- ``berlekamp_massey_scan_plain`` on random syndromes (not from codewords)
  against a per-row Berlekamp-Massey on host field ints written here, with
  erasure offsets u = 0, d - 1, beyond d - 1 and random, and rows whose
  discrepancy is 0; d in {3, 17, 33, 65}, m in {4, 8, 9, 16}.
- K8-B's table step emulated in plain torch on ``pack_tables``' layout (the
  kernel's LOG/EXP indices, its (q-1) - LOG[bb] register, the doubled EXP of
  the byte rows, the INV form of GF(2^15) and GF(2^16)) against
  ``berlekamp_massey_scan_plain`` for m = 2..16 over the kernel's d range.
- RS(255,191) (d = 65, the kernel's edge) and RS(255,187) (d = 69, the
  plain scan on every device) decoded with errors and erasures against the
  JAX package; BCH(511,493) (m = 9, d = 5) routed to K8-B, with t and t + 1
  errors.
- ``bm_scan_supports`` on a grid; the routing of ``BinaryExtOps.reciprocal``,
  ``power`` and ``power_static`` and of the decoder's scan.

Inputs are made with numpy from a seed; the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu.ops._kernels import get_ops as jax_get_ops
from galois_tpu_torch.codes._decoder import make_decoder
from galois_tpu_torch.ops import _kernels
from galois_tpu_torch.ops._bm_scan import (
    MAX_D,
    MAX_D_WIDE,
    berlekamp_massey_scan,
    berlekamp_massey_scan_plain,
    bm_scan_supports,
)
from galois_tpu_torch.ops._elementwise import gf2m_power, gf2m_power_plain
from galois_tpu_torch.ops._kernels import get_ops


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    with gt.default_device("cpu"):
        yield


def _polys(m):
    """The field's default f and, where there is one, another irreducible f."""
    f = gj.GF(2**m)._meta.irreducible_poly_int
    other = int(gj.irreducible_poly(2, m, method="max"))
    return [f] if other == f else [f, other]


def _elements(m, rng):
    if m <= 12:
        return np.arange(2**m, dtype=np.int64)
    a = rng.integers(0, 2**m, 4099)
    a[:3] = [0, 1, 2**m - 1]
    return a


def _jax_ops(m, f):
    """The JAX package's calculate ops for GF(2^m) with f, and its storage dtype."""
    meta = gj.GF(2**m, irreducible_poly=f)._meta
    return jax_get_ops(meta, "jit-calculate"), meta.internal_dtype


def _dt(m):
    return torch.uint8 if m <= 8 else torch.int64


@pytest.mark.parametrize("m", range(2, 17))
def test_power_plain_reciprocal_matches_jax(m):
    rng = np.random.default_rng(m)
    a = _elements(m, rng)
    for f in _polys(m):
        got = gf2m_power_plain(torch.from_numpy(a).to(_dt(m)), None, m, f)
        assert got.dtype == _dt(m)
        jops, jdt = _jax_ops(m, f)
        want = np.asarray(jops.reciprocal(a.astype(jdt)))
        assert np.array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("m", range(2, 17))
def test_power_plain_exponents_match_jax(m):
    rng = np.random.default_rng(100 + m)
    a = _elements(m, rng)
    q1 = 2**m - 1
    at = torch.from_numpy(a).to(_dt(m))
    for f in _polys(m):
        jops, jdt = _jax_ops(m, f)
        aj = a.astype(jdt)
        for e in (0, 1, 2, q1 - 1, q1):  # one exponent for all, broadcast from 0-D
            got = gf2m_power_plain(at, torch.tensor(e), m, f, nbits=max(1, e.bit_length()))
            want = np.asarray(jops.power(aj, np.full(a.shape, e, dtype=np.int64)))
            assert np.array_equal(got.to(torch.int64).numpy(), want.astype(np.int64)), e
        e = rng.integers(0, 2**40, a.shape)
        e[:4] = [0, 0, q1, 2 * q1]
        got = gf2m_power_plain(at, torch.from_numpy(e), m, f, nbits=40)
        want = np.asarray(jops.power(aj, e))
        assert np.array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))
        # broadcast: a row of bases against a column of exponents
        k = min(64, a.size)
        ec = rng.integers(0, 2**m + 3, (5, 1))
        got = gf2m_power_plain(at[None, :k], torch.from_numpy(ec), m, f, nbits=m + 2)
        want = np.asarray(jops.power(np.broadcast_to(aj[:k], (5, k)), np.broadcast_to(ec, (5, k))))
        assert got.shape == (5, k) and np.array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))


def _host_bm(hf, S, u, d):
    """Berlekamp-Massey on host ints, one row, masked as the decoder's scan:
    steps t < u do nothing, relative steps are t - u, x B drops the
    coefficient of x^d."""
    C, B, L, b = [1] + [0] * (d - 1), [1] + [0] * (d - 1), 0, 1
    for t in range(d - 1):
        if t < u:
            continue
        delta = 0
        for i in range(t + 1):
            delta = hf.add(delta, hf.multiply(C[i], S[t - i]))
        xB = [0] + B[:-1]
        if delta == 0:
            B = xB
            continue
        coef = hf.multiply(delta, hf.reciprocal(b))
        T = [hf.subtract(c, hf.multiply(coef, x)) for c, x in zip(C, xB)]
        if 2 * L <= t - u:
            B, L, b = C, t - u + 1 - L, delta
        else:
            B = xB
        C = T
    return C, L


def _scan_inputs(m, d, rows, seed):
    """Random S' (rows, d - 1) with an all-zero row and a row that starts
    with a run of zeros, and offsets u with 0, d - 1 and past d - 1."""
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 2**m, (rows, d - 1))
    S[1] = 0  # every discrepancy 0
    S[2, : (d - 1) // 2] = 0  # a run of zero discrepancies first
    u = rng.integers(0, d + 2, rows)
    u[:5] = [0, 0, 0, d - 1, d + 4]
    return S, u


@pytest.mark.parametrize("m", [4, 8, 9, 16])
@pytest.mark.parametrize("d", [3, 17, 33, 65])
def test_scan_plain_matches_host_berlekamp_massey(m, d):
    rows = 24
    S, u = _scan_inputs(m, d, rows, 10 * m + d)
    F = gt.GF(2**m)
    C, L = berlekamp_massey_scan_plain(get_ops(F._meta, F._mode), torch.from_numpy(S).to(_dt(m)), torch.from_numpy(u), d)
    assert C.shape == (rows, d) and C.dtype == _dt(m) and L.dtype == torch.int64
    hf = get_host_field(gj.GF(2**m)._meta)
    for i in range(rows):
        c, l = _host_bm(hf, [int(v) for v in S[i]], int(u[i]), d)
        assert C[i].tolist() == c and int(L[i]) == l, i
    # the wrapper serves CPU tensors with the plain version and counts nothing
    launches = berlekamp_massey_scan.launches
    C2, L2 = berlekamp_massey_scan(get_ops(F._meta, F._mode), torch.from_numpy(S).to(_dt(m)), torch.from_numpy(u), d)
    assert berlekamp_massey_scan.launches == launches and torch.equal(C2, C) and torch.equal(L2, L)


def _scan_by_tables(ops, S, u, d):
    """K8-B's scan as the kernel computes it, in plain torch: the table is
    ``ops.packed_tables``' layout, read at the kernel's indices. Per row the
    kernel keeps kb = (q-1) - LOG[bb] (bb = 1 at the start, so kb = q-1)
    and takes coef = EXP[LOG[delta] + kb]: from the doubled EXP of the byte
    rows for m <= 8, whose multiply table is EXP[LOG coef + LOG[x^i]]; from
    the reduced EXP after one conditional subtract for 9 <= m <= 14. For
    m = 15, 16 kb is INV[bb] and coef = delta * kb. For m <= 8 delta is the
    XOR of the unreduced carry-less products, reduced by the table of
    x^(m + j) mod f. Every index is checked against the table's rows, and
    coef is 0 where delta is 0."""
    meta = ops.meta
    m, f = meta.degree, meta.irreducible_poly_int
    q1 = 2**m - 1
    tab = ops.packed_tables(S.device).to(torch.int64)
    if m <= 8:
        assert tab.shape == (2 * q1,)
        LOG, EXP, NLOG = tab & 0xFF, (tab >> 8) & 0xFF, (tab >> 16) & 0xFF
        lx = [int(LOG[1 << i]) for i in range(m)]
        xr = [f ^ (1 << m)]  # x^(m + j) mod f, j < m - 1
        for _ in range(m - 2):
            c = xr[-1] << 1
            xr.append(c ^ f if c >> m else c)
    else:
        tab = tab & 0xFFFF
        LOG, EXP, INV = tab[: q1 + 1], tab[q1 + 1 : 2 * q1 + 1], tab[2 * q1 + 2 : 3 * q1 + 3]
    rows, dt = S.shape[0], S.dtype
    C = torch.zeros((rows, d), dtype=torch.int64)
    C[:, 0] = 1
    Bp = C.clone()
    L = torch.zeros(rows, dtype=torch.int64)
    kb = torch.full((rows,), 1 if m > 14 else q1, dtype=torch.int64)
    Sl = S.to(torch.int64)
    for t in range(d - 1):
        if m <= 8:  # the unreduced carry-less sum, then the linear map of its high bits
            a, b = C[:, : t + 1], Sl[:, : t + 1].flip(1)
            acc = torch.zeros_like(a)
            for i in range(m):
                acc ^= torch.where((b >> i) & 1 == 1, a << i, 0)
            total = torch.zeros(rows, dtype=torch.int64)
            for i in range(t + 1):
                total ^= acc[:, i]
            delta = total & q1
            for j in range(m - 1):
                delta ^= torch.where((total >> (m + j)) & 1 == 1, xr[j], 0)
        else:
            prods = ops.multiply(C[:, : t + 1].to(dt), Sl[:, : t + 1].flip(1).to(dt)).to(torch.int64)
            delta = torch.zeros(rows, dtype=torch.int64)
            for i in range(t + 1):
                delta ^= prods[:, i]
        if m <= 8:
            sc = LOG[delta] + kb
            assert int(sc.max()) < 2 * q1  # inside the doubled EXP
            lc = torch.where(sc >= q1, sc - q1, sc)
            cx = [EXP[lc + lx[i]] for i in range(m)]
            assert torch.equal(cx[0], EXP[sc])  # LOG[x^0] = 0: the first entry is coef
            grown = NLOG[delta]
        else:
            if m <= 14:
                lg = LOG[delta]
                sc = lg + kb
                assert int(sc.max()) < 2 * q1
                coef = EXP[torch.where(sc >= q1, sc - q1, sc)]
                grown = q1 - lg
            else:
                coef = ops.multiply(delta, kb)
                grown = INV[delta]
            cx, c = [], coef
            for i in range(m):  # the kernel's const_table: coef x^i mod f
                cx.append(c)
                c = c << 1
                c = c ^ torch.where((c >> m) & 1 == 1, f, 0)
        cx = [torch.where(delta == 0, 0, c) for c in cx]
        xB = torch.cat([torch.zeros((rows, 1), dtype=torch.int64), Bp[:, :-1]], dim=1)
        prod = torch.zeros_like(xB)
        for i in range(m):
            prod ^= torch.where((xB >> i) & 1 == 1, cx[i][:, None], 0)
        active = t >= u
        upd = active & (delta != 0)
        grow = upd & (2 * L <= t - u)
        Bp = torch.where(active[:, None], torch.where(grow[:, None], C, xB), Bp)
        kb = torch.where(grow, grown, kb)
        L = torch.where(grow, t - u + 1 - L, L)
        C = torch.where(upd[:, None], C ^ prod, C)
    return C.to(dt), L


@pytest.mark.parametrize("m", range(2, 17))
def test_scan_table_step_matches_plain(m):
    """The kernel's table step (``_scan_by_tables``) equals the plain scan
    at the short, middle and longest d of K8-B's domain for this m."""
    F = gt.GF(2**m)
    ops = get_ops(F._meta, F._mode)
    for d in (2, 5, 17, MAX_D if m <= 8 else MAX_D_WIDE):
        assert bm_scan_supports(m, d)
        S, u = _scan_inputs(m, d, 40, 1000 * m + d)
        S[3] = 2**m - 1
        St, ut = torch.from_numpy(S).to(_dt(m)), torch.from_numpy(u)
        C, L = _scan_by_tables(ops, St, ut, d)
        Cp, Lp = berlekamp_massey_scan_plain(ops, St, ut, d)
        assert torch.equal(C, Cp) and torch.equal(L, Lp), d


def _rs_words(code, rows, seed):
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, code.field.order, (rows, code.k))
    return msg, np.asarray(code.encode(code.field(msg))).astype(np.int64)


@pytest.mark.parametrize("k", [191, 187])
def test_rs_at_and_past_the_scan_edge_matches_jax(k):
    """RS(255,191) has d = 65, the kernel's largest; RS(255,187), d = 69,
    keeps the plain scan on every device. Errors, then errors and erasures."""
    ct, cj = gt.ReedSolomon(255, k), gj.ReedSolomon(255, k)
    assert ct.d == 256 - k
    dec = make_decoder(ct.field._meta, ct.field._mode, 256, 255, 255, ct.d, ct.c, int(ct.alpha), False)
    assert dec._scan is (berlekamp_massey_scan if k == 191 else berlekamp_massey_scan_plain)
    rows = 6
    msg, cw = _rs_words(cj, rows, seed=k)
    rng = np.random.default_rng(k + 1)
    counts = [0, 1, ct.t, ct.t + 1, 2 * ct.t + 3, ct.t // 2]
    era = np.zeros(cw.shape, dtype=bool)
    rx = cw.copy()
    for i, e in enumerate(counts):
        pos = rng.choice(255, size=e, replace=False)
        rx[i, pos] ^= rng.integers(1, 256, e)
    dt, et = ct.decode(ct.field.from_numpy(rx), errors=True)
    dj, ej = cj.decode(cj.field(rx), errors=True)
    assert np.array_equal(np.asarray(dt), np.asarray(dj)) and np.array_equal(et, ej)
    ok = np.asarray(counts) <= ct.t
    assert np.array_equal(np.asarray(dt)[ok], msg[ok]) and (et == -1).any()
    # erasures: f erasures and e errors with 2e + f around d - 1
    rx = cw.copy()
    for i in range(rows):
        f = int(rng.integers(0, ct.d + 2))
        e = max(0, (ct.d - 1 - f) // 2 + (i % 3 == 2))
        pos = rng.choice(255, size=f + e, replace=False)
        era[i, pos[:f]] = True
        rx[i, pos] ^= rng.integers(1, 256, f + e)
    dt, et = ct.decode(ct.field.from_numpy(rx), erasures=era, errors=True)
    dj, ej = cj.decode(cj.field(rx), erasures=era, errors=True)
    assert np.array_equal(np.asarray(dt), np.asarray(dj)) and np.array_equal(et, ej)


def test_scan_supports_grid():
    # the codes: RS(255,223) and CCSDS, RS(255,191), QR-class and DVB
    # (m = 8); the tests' RS(15,11) and RS(31,25); BCH(511,493) (m = 9,
    # d = 5) and GF(2^16) codes up to d = 33; d = 69 at m = 8, d = 34 above
    # it, GF(2), GF(2^17) and d = 1 are outside
    cases = {(8, 33): True, (8, 65): True, (8, 17): True, (4, 5): True, (5, 7): True, (2, 2): True,
             (9, 5): True, (16, 9): True, (16, 33): True, (12, 2): True,
             (8, 69): False, (8, 66): False, (9, 34): False, (16, 65): False, (17, 5): False, (1, 3): False,
             (8, 1): False}
    for (m, d), want in cases.items():
        assert bm_scan_supports(m, d) is want, (m, d)
    for m in range(1, 18):
        for d in range(1, 80):
            assert bm_scan_supports(m, d) == (2 <= d <= 65 if 2 <= m <= 8 else 9 <= m <= 16 and 2 <= d <= 33)


def test_bch_511_493_routes_to_the_scan_kernel_and_matches_jax():
    """BCH(511,493): GF(2^9) syndromes, d = 5, inside K8-B's domain, so its
    decoder takes the kernel's wrapper (the CPU runs the plain version);
    rows with t and t + 1 bit errors decode as the JAX package's do."""
    ct, cj = gt.BCH(511, 493), gj.BCH(511, 493)
    ext = ct.extension_field
    assert (ext.degree, ct.d, ct.t) == (9, 5, 2)
    dec = make_decoder(ext._meta, ext._mode, 2, 511, 511, ct.d, ct.c, int(ct.alpha), False)
    assert dec._scan is berlekamp_massey_scan
    rng = np.random.default_rng(511)
    rows = 8
    msg = rng.integers(0, 2, (rows, ct.k))
    cw = np.asarray(cj.encode(cj.field(msg))).astype(np.int64)
    counts = [0, 1, ct.t, ct.t + 1, ct.t, ct.t + 1, 1, ct.t + 1]
    for i, e in enumerate(counts):
        cw[i, rng.choice(511, size=e, replace=False)] ^= 1
    launches = berlekamp_massey_scan.launches
    dt, et = ct.decode(ct.field.from_numpy(cw), errors=True)
    dj, ej = cj.decode(cj.field(cw), errors=True)
    assert berlekamp_massey_scan.launches == launches  # the plain version on the CPU
    assert np.array_equal(np.asarray(dt), np.asarray(dj)) and np.array_equal(et, ej)
    ok = np.asarray(counts) <= ct.t
    assert np.array_equal(np.asarray(dt)[ok], msg[ok]) and np.array_equal(et[ok], np.asarray(counts)[ok])


@pytest.mark.parametrize("m", [2, 8, 9, 16, 17])
def test_binary_powers_route_to_the_power_kernel(monkeypatch, m):
    """GF(2^m) reciprocal, power and power_static take K8-A's wrapper for
    m <= 16 (by field, on any device; the CPU runs its plain version) and
    torch chains above; every result equals the JAX package's."""
    calls = []
    real = _kernels.gf2m_power
    monkeypatch.setattr(_kernels, "gf2m_power", lambda *args: (calls.append(args[1] is None), real(*args))[1])
    Ft, Fj = gt.GF(2**m), gj.GF(2**m)
    rng = np.random.default_rng(m)
    x = rng.integers(1, 2**m, 200)
    e = rng.integers(-50, 5000, 200)
    launches = gf2m_power.launches
    xt, xj = Ft(x), Fj(x)
    for got, want in (
        (xt ** -1, xj ** -1),
        (np.reciprocal(xt), np.reciprocal(xj)),
        (xt ** e, xj ** e),
        (xt ** 12345, xj ** 12345),
        (xt ** (2**m - 1), xj ** (2**m - 1)),
        (xt ** -7, xj ** -7),
        (xt / Ft(x[::-1].copy()), xj / Fj(x[::-1].copy())),
        (Ft(0) ** 0, Fj(0) ** 0),
        (Ft(0) ** 5, Fj(0) ** 5),
    ):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert gf2m_power.launches == launches  # plain versions on the CPU
    if m <= 16:
        assert True in calls and False in calls  # reciprocals and exponent tensors
    else:
        assert calls == []


def test_power_wrapper_refuses_other_devices_and_operands():
    a = torch.arange(256, dtype=torch.uint8)
    with pytest.raises(ValueError):  # not CPU and not CUDA: raise rather than fall back
        gf2m_power(a.to("meta"), None, 8, 0x11D)
    with pytest.raises(ValueError):
        gf2m_power(a.to("meta"), torch.zeros(256, dtype=torch.int64, device="meta"), 8, 0x11D, 8)
    S = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    F = gt.GF(2**8)
    with pytest.raises(ValueError):
        berlekamp_massey_scan(get_ops(F._meta, F._mode), S, torch.zeros(4, dtype=torch.int64, device="meta"), 33)
