"""``np.convolve`` and Poly's device product and division of the torch port
against the JAX package.

Each of the three strategies of ``ops/_convolve.py`` (the NTT, the exact
int64 multiply-accumulate, field multiply-adds) is reached over GF(2),
GF(2^8), GF(2^16), GF(3^5), GF(7), GF(3 * 2^30 + 1), GF(2^31 - 1) and the
Goldilocks field, and Poly ``*``, ``divmod``, ``%``, ``//`` and both power
ladders above ``_DEVICE_POLY_WORK`` over GF(3 * 2^30 + 1) and GF(2^8). The
same inputs, made with numpy from a seed, go through ``galois_tpu`` and
``galois_tpu_torch``; the tolerance is exact integer equality.
"""

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu_torch.ops import _convolve, _ntt, _poly_div
from galois_tpu_torch.ops._kernels import get_ops
from galois_tpu_torch.polys._poly import _DEVICE_POLY_WORK

P = 3 * 2**30 + 1
M31 = 2**31 - 1
GOLDILOCKS = 2**64 - 2**32 + 1


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _route(monkeypatch, Ft):
    """Count the NTT's transforms and the field multiplies of one call."""
    seen = {"fft": 0, "multiply": 0}
    fft_data, ops = _ntt.fft_data, get_ops(Ft._meta, Ft._mode)
    multiply = ops.multiply

    def counting_fft(*args, **kwargs):
        seen["fft"] += 1
        return fft_data(*args, **kwargs)

    def counting_multiply(*args):
        seen["multiply"] += 1
        return multiply(*args)

    monkeypatch.setattr(_ntt, "fft_data", counting_fft)
    monkeypatch.setattr(ops, "multiply", counting_multiply)
    return seen


# (order, n, m, strategy): the NTT at N = 255 over GF(2^8), GF(2^16); 242
# over GF(3^5); 512 and 768 = 3 * 2^8 over GF(3 * 2^30 + 1); over GF(2^31 - 1)
# N = 558 = 2 * 3^2 * 31
CASES = [
    (2, 70, 65, "multiply-add"),  # q - 1 = 1 has no NTT size
    (2**8, 100, 70, "ntt"),
    (2**8, 40, 20, "multiply-add"),
    (2**16, 100, 80, "ntt"),
    (2**16, 33, 9, "multiply-add"),
    (3**5, 90, 70, "ntt"),
    (7, 200, 100, "int64"),
    (P, 300, 200, "ntt"),
    (P, 400, 300, "ntt"),
    (P, 30, 5, "multiply-add"),  # (p - 1)^2 >= 2^63
    (M31, 300, 200, "ntt"),
    (M31, 20, 1, "int64"),
    (M31, 20, 7, "multiply-add"),
    (GOLDILOCKS, 12, 3, "multiply-add"),  # limb storage
]


@pytest.mark.parametrize(["order", "n", "m", "strategy"], CASES)
def test_convolve_matches_jax(monkeypatch, order, n, m, strategy):
    Ft, Fj = gt.GF(order), gj.GF(order)
    a, b = Fj.Random(n, seed=n), Fj.Random(m, seed=m + 1)
    want = np.convolve(a, b)
    seen = _route(monkeypatch, Ft)
    at, bt = Ft(np.asarray(a)), Ft(np.asarray(b))
    _same(np.convolve(at, bt), want)
    if strategy == "ntt":
        assert seen["fft"] == 2 and seen["multiply"] >= 1  # one batched forward, one inverse
    else:
        assert seen["fft"] == 0 and (seen["multiply"] > 0) == (strategy == "multiply-add")
    # the shorter operand first, and a host operand coerced to the field
    _same(np.convolve(bt, at), want)
    _same(_convolve.convolve(at, np.asarray(b)), want)


@pytest.mark.parametrize(["order", "n", "m"], [(7, 50, 23), (2**8, 50, 23), (GOLDILOCKS, 20, 7)])
def test_convolve_in_chunks_of_taps(monkeypatch, order, n, m):
    """A small memory budget gives chunks of a few taps and a ragged last
    one: the result stays that of one chunk (which the test above holds
    against the JAX package)."""
    F = gt.GF(order)
    a, b = F.Random(n, seed=3), F.Random(m, seed=4)
    want = np.convolve(a, b)
    monkeypatch.setattr(_convolve, "_OUTER_BYTES", 40 * 64 * n)
    _same(np.convolve(a, b), want)


def test_convolve_argument_errors():
    F = gt.GF(7)
    x = F([1, 2, 3])
    with pytest.raises(ValueError, match="mode"):
        np.convolve(x, x, mode="same")
    with pytest.raises(ValueError, match="1-D"):
        np.convolve(F([[1, 2], [3, 4]]), x)
    with pytest.raises(TypeError):
        _convolve.convolve([1, 2], [3, 4])
    Fj = gj.GF(7)
    for call in (lambda G: np.convolve(G([1, 2, 3]), G([1, 2]), mode="valid"), lambda G: np.convolve(G([[1]]), G([1]))):
        with pytest.raises(ValueError):
            call(Fj)
        with pytest.raises(ValueError):
            call(F)


def test_ntt_size_matches_jax():
    from galois_tpu.ops._convolve import _ntt_size as jax_ntt_size

    for order in (2, 7, 2**8, 2**16, 3**5, P, M31):
        for out_len in (1, 5, 64, 255, 256, 500, 769, 10**6):
            assert _convolve._ntt_size(gt.GF(order)._meta, out_len) == jax_ntt_size(gj.GF(order)._meta, out_len)


def _rand_coeffs(q, n, seed):
    c = np.random.default_rng(seed).integers(0, q, n)
    c[0] = max(c[0], 1)
    return c


def _pair(q, coeffs):
    return gt.Poly(coeffs, field=gt.GF(q)), gj.Poly(coeffs, field=gj.GF(q))


def _same_poly(pt, pj):
    assert isinstance(pt, gt.Poly) and pt.degree == pj.degree
    _same(pt.coeffs, pj.coeffs)


def _device_calls(monkeypatch):
    """Count the device product and division calls Poly makes."""
    seen = {"convolve": 0, "divmod": 0}
    conv, div = _convolve.convolve, _poly_div.poly_divmod_device

    def counting_convolve(*args):
        seen["convolve"] += 1
        return conv(*args)

    def counting_divmod(*args):
        seen["divmod"] += 1
        return div(*args)

    monkeypatch.setattr(_convolve, "convolve", counting_convolve)
    monkeypatch.setattr(_poly_div, "poly_divmod_device", counting_divmod)
    return seen


@pytest.mark.parametrize(["order", "na", "nb"], [(P, 400, 400), (2**8, 4096, 32)])
def test_poly_device_product_and_division_match_jax(monkeypatch, order, na, nb):
    """400 x 400 coefficients over GF(3 * 2^30 + 1) take the NTT at N = 1024;
    GF(2^8) has no NTT size that long and takes the multiply-adds."""
    assert na * nb >= _DEVICE_POLY_WORK
    at, aj = _pair(order, _rand_coeffs(order, na, 1))
    bt, bj = _pair(order, _rand_coeffs(order, nb, 2))
    seen = _device_calls(monkeypatch)
    prod_t, prod_j = at * bt, aj * bj
    _same_poly(prod_t, prod_j)
    assert seen["convolve"] == 1
    # (deg q + 1)(deg b + 1) = 513 * 256 >= 2^17
    dt, dj = _pair(order, _rand_coeffs(order, 256, 3))
    ct, cj = _pair(order, _rand_coeffs(order, 768, 4))
    qt, rt = divmod(ct, dt)
    qj, rj = divmod(cj, dj)
    _same_poly(qt, qj)
    _same_poly(rt, rj)
    _same_poly(ct % dt, cj % dj)
    _same_poly(ct // dt, cj // dj)
    assert seen["divmod"] == 3
    # below the threshold both stay on the host
    et, ej = _pair(order, _rand_coeffs(order, 8, 5))
    _same_poly(at * et, aj * ej)
    assert seen["convolve"] == 1


@pytest.mark.parametrize("order", [P, 2**8])
def test_poly_device_powers_match_jax(monkeypatch, order):
    """The modular ladder at deg m = 400 (deg_m^2 >= 2^17) and the plain one
    at (deg e)^2 >= 4 * 2^17. The JAX package serves GF(2^8)'s references in
    python-calculate mode (its host ladders: the same polynomials, without
    compiling a 400-tap product)."""
    at, aj = _pair(order, _rand_coeffs(order, 400, 6))
    mt, mj = _pair(order, _rand_coeffs(order, 401, 7))
    seen = _device_calls(monkeypatch)
    got_mod, got_pow = pow(at, 3, mt), at**2
    assert seen["convolve"] >= 2 and seen["divmod"] >= 1
    Fj = gj.GF(order)
    if order == P:
        want_mod, want_pow = pow(aj, 3, mj), aj**2
    else:
        try:
            Fj.compile("python-calculate")
            want_mod, want_pow = pow(aj, 3, mj), aj**2
        finally:
            Fj.compile("auto")
    _same_poly(got_mod, want_mod)
    _same_poly(got_pow, want_pow)
