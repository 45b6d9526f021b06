"""Field layer of the torch port against the JAX package.

The same inputs, made with numpy from a seed, go through ``galois_tpu`` and
``galois_tpu_torch``; the tolerance is exact integer equality, since these
are finite-field results. Kernel K7 (GF(2^m) multiply) is held here against
the JAX Pallas kernel in interpret mode and against exact host arithmetic.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu.fields._hostfield import get_host_field
from galois_tpu.ops._pallas import gf2m_multiply_pallas
from galois_tpu_torch.ops._elementwise import gf2m_multiply, gf2m_multiply_plain

ORDERS = [2, 2**8, 257, 2**31 - 1, 3 * 2**30 + 1]
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """These tests run the plain versions on the CPU: ask for it, since new
    data goes to CUDA by default."""
    with gt.default_device("cpu"):
        yield


def _operands(order, seed, n=64):
    """Random elements plus the corner values 0, 1 and order - 1."""
    rng = np.random.default_rng(seed)
    corners = np.array([0, 1, order - 1, 0, 1, order - 1, 1, 0], dtype=np.int64)
    a = np.concatenate([corners, rng.integers(0, order, n, dtype=np.int64)])
    b = np.concatenate([corners[::-1], rng.integers(0, order, n, dtype=np.int64)])
    return a, b


def _same(x_torch, x_jax):
    got, want = np.asarray(x_torch), np.asarray(x_jax)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("order", ORDERS)
def test_field_properties_match(order):
    Ft, Fj = gt.GF(order), gj.GF(order)
    assert Ft.characteristic == Fj.characteristic
    assert Ft.degree == Fj.degree
    assert int(Ft.primitive_element) == int(Fj.primitive_element)
    assert Ft._meta.irreducible_poly_int == Fj._meta.irreducible_poly_int
    assert Ft._meta.internal_dtype == Fj._meta.internal_dtype
    assert Ft.dtypes == Fj.dtypes
    assert gt.GF(order) is Ft  # flyweight cache


def _host_map(Fj, fn, *arrays):
    """Apply the JAX package's exact host-field op elementwise. Used where the
    JAX device path would compile a long exponentiation chain per exponent."""
    hf = get_host_field(Fj._meta)
    out = [getattr(hf, fn)(*(int(v) for v in vals)) for vals in zip(*arrays)]
    return np.array(out, dtype=np.int64).astype(Fj._meta.internal_dtype)


@pytest.mark.parametrize("order", ORDERS)
def test_binary_arithmetic_matches_jax(order):
    a, b = _operands(order, seed=order % 1000)
    Ft, Fj = gt.GF(order), gj.GF(order)
    xt, yt, xj, yj = Ft(a), Ft(b), Fj(a), Fj(b)
    _same(xt + yt, xj + yj)
    _same(xt - yt, xj - yj)
    _same(xt * yt, xj * yj)
    _same(-xt, -xj)
    _same(np.multiply(xt, yt), np.multiply(xj, yj))
    _same(np.add(xt, yt), np.add(xj, yj))
    _same(np.subtract(xt, yt), np.subtract(xj, yj))
    nz = b.copy()
    nz[nz == 0] = 1
    _same(xt / Ft(nz), _host_map(Fj, "divide", a, nz))
    _same(np.reciprocal(Ft(nz)), _host_map(Fj, "reciprocal", nz))


@pytest.mark.parametrize("order", ORDERS)
def test_power_matches_jax(order):
    a, _ = _operands(order, seed=7)
    Ft, Fj = gt.GF(order), gj.GF(order)
    for e in (0, 1, 3):
        _same(Ft(a) ** e, Fj(a) ** e)
    for e in (order - 2, order - 1, order, 2**70 + 3):
        _same(Ft(a) ** e, _host_map(Fj, "power", a, [e] * len(a)))
    nz = a.copy()
    nz[nz == 0] = 1
    for e in (-1, -5):
        _same(Ft(nz) ** e, _host_map(Fj, "power", nz, [e] * len(nz)))
    exps = np.random.default_rng(3).integers(-40, 40, a.shape[0])
    exps[:4] = [0, 7, 0, -3]
    _same(Ft(nz) ** exps, Fj(nz) ** exps)
    zero_base = np.zeros(4, dtype=np.int64)
    _same(Ft(zero_base) ** np.array([0, 1, 2, order - 1]), Fj(zero_base) ** np.array([0, 1, 2, order - 1]))


@pytest.mark.parametrize("order", ORDERS)
def test_broadcasting_and_scalars_match_jax(order):
    rng = np.random.default_rng(11)
    col = rng.integers(0, order, (5, 1), dtype=np.int64)
    row = rng.integers(0, order, (1, 4), dtype=np.int64)
    Ft, Fj = gt.GF(order), gj.GF(order)
    _same(Ft(col) * Ft(row), Fj(col) * Fj(row))
    _same(Ft(col) + Ft(row), Fj(col) + Fj(row))
    _same(Ft(row) - Ft(order - 1), Fj(row) - Fj(order - 1))
    # an integer operand to multiply is repeated addition
    _same(Ft(col) * 3, Fj(col) * 3)
    _same(5 * Ft(row), 5 * Fj(row))
    _same(Ft(col) * np.array([2, 3, 4, 5]), Fj(col) * np.array([2, 3, 4, 5]))


def test_field_errors_match_jax_contract():
    F = gt.GF(257)
    with pytest.raises(ValueError):
        F([0, 257])
    with pytest.raises(TypeError):
        F(np.array([1.0]))
    with pytest.raises(TypeError):
        F([1, 2]) + 1
    with pytest.raises(ZeroDivisionError):
        F([1, 2]) / F([1, 0])
    with pytest.raises(ZeroDivisionError):
        F([0, 2]) ** -1
    with pytest.raises(TypeError):
        F([1]) + gt.GF(7)([1])
    with pytest.raises(LookupError):
        gt.GF(2**128)  # no Conway polynomial for it, as in the JAX package


def test_from_numpy_and_devices():
    p = 3 * 2**30 + 1
    rng = np.random.default_rng(2)
    vals = rng.integers(0, p, (3, 7), dtype=np.int64)
    xj = gj.GF(p)(vals)
    xt = gt.GF(p).from_numpy(np.asarray(xj))
    assert xt.device == torch.device("cpu")
    assert xt._data.dtype == torch.int64
    _same(xt, xj)
    assert gt.GF(2**8)([1, 2])._data.dtype == torch.uint8
    with pytest.raises(ValueError):
        gt.GF(p).from_numpy(np.array([p], dtype=np.uint64))
    g = torch.Generator().manual_seed(5)
    r = gt.GF(2**8).Random((4, 4), generator=g, device="cpu")
    assert r.shape == (4, 4) and int(np.asarray(r).max()) < 256
    assert np.array_equal(
        np.asarray(gt.GF(p).Random(10, seed=9)), np.asarray(gt.GF(p).Random(10, seed=9))
    )
    z = gt.GF(p).Zeros((2, 3), device="cpu")
    assert np.array_equal(np.asarray(z), np.zeros((2, 3), dtype=np.uint32))


# ----------------------------------------------------------------------
# Kernel K7: GF(2^m) multiply
# ----------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 8, 16])
def test_gf2m_multiply_plain_matches_pallas_and_host(m):
    import jax.numpy as jnp

    Fj = gj.GF(2**m)
    f_int = Fj._meta.irreducible_poly_int
    assert gt.GF(2**m)._meta.irreducible_poly_int == f_int
    rng = np.random.default_rng(m)
    n = 9_000  # not a multiple of the TPU kernel's (8, 1024) block
    a = rng.integers(0, 2**m, n, dtype=np.int64)
    b = rng.integers(0, 2**m, n, dtype=np.int64)
    np_dt = Fj._meta.internal_dtype
    want = np.asarray(
        gf2m_multiply_pallas(jnp.asarray(a.astype(np_dt)), jnp.asarray(b.astype(np_dt)), m, f_int, True)
    ).astype(np.int64)
    t_dt = gt.GF(2**m)._meta.torch_dtype
    got = gf2m_multiply_plain(torch.from_numpy(a).to(t_dt), torch.from_numpy(b).to(t_dt), m, f_int)
    assert got.dtype == t_dt
    assert np.array_equal(got.to(torch.int64).numpy(), want)
    hf = get_host_field(Fj._meta)
    host = np.array([hf.multiply(int(x), int(y)) for x, y in zip(a[:300], b[:300])])
    assert np.array_equal(want[:300], host)


def test_gf2m_multiply_wrapper_uses_plain_on_cpu_only():
    F = gt.GF(2**8)
    f_int = F._meta.irreducible_poly_int
    a = torch.arange(256, dtype=torch.uint8)
    before = gf2m_multiply.launches
    out = gf2m_multiply(a, a.flip(0), 8, f_int)
    assert gf2m_multiply.launches == before  # the plain version is no launch
    assert torch.equal(out, gf2m_multiply_plain(a, a.flip(0), 8, f_int))
    # not CPU and not CUDA: raise rather than fall back
    with pytest.raises(ValueError):
        gf2m_multiply(a.to("meta"), a.to("meta"), 8, f_int)


# ----------------------------------------------------------------------
# Package boundary
# ----------------------------------------------------------------------

def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import galois_tpu_torch\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'galois_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|galois_tpu)(\.|\s|$)", re.M)
    # a path or resource built into the JAX package: "galois_tpu" / ..., "galois_tpu._databases"
    # or "galois_tpu/<file>"; "galois_tpu/<file>:<line>" names a kernel a port replaces
    path_into_jax = re.compile(r"""["']galois_tpu["'.]|["']galois_tpu/[^"':]*["']""")
    names = ("_timing.py", "lookup_timing.py", "scan_timing.py", "power_timing.py", "limb_timing.py", "linalg_timing.py")
    scripts = [REPO / "scripts" / name for name in names]
    for path in [*(REPO / "galois_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py", *scripts]:
        text = path.read_text()
        assert not pattern.search(text), path
        assert not path_into_jax.search(text), path


def test_conway_table_is_the_ports_own_copy():
    from galois_tpu_torch import _databases

    path = _databases._CONWAY_PATH
    assert path.parent == REPO / "galois_tpu_torch" / "_databases" and path.exists()
    assert path.read_bytes() == (REPO / "galois_tpu" / "_databases" / "conway_polys.npz").read_bytes()
    assert gt.GF(3**10)._meta.irreducible_poly_int == gj.GF(3**10)._meta.irreducible_poly_int


def test_new_arrays_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    F = gt.GF(2**8)
    cpu = F([1, 2, 3])  # the module's CPU request
    with gt.default_device("cuda"):
        for make in (
            lambda: F([1, 2]),
            lambda: F.from_numpy(np.array([1, 2])),
            lambda: F.Zeros(3),
            lambda: F.Random(3, seed=1),
            lambda: gt.ntt([1, 2, 3, 4], modulus=5),
        ):
            with pytest.raises(RuntimeError, match="set_default_device"):
                make()
        # data that already lies on a device stays there
        assert (cpu * cpu).device == torch.device("cpu")
        assert F(cpu._data).device == torch.device("cpu")
    assert F([4]).device == torch.device("cpu")  # the context manager restored the CPU


def test_poly_conversions_match_jax():
    from galois_tpu.polys import _conversions as cj
    from galois_tpu_torch.polys import _conversions as ct

    for value, order in [(0, 2), (283, 2), (2 * 7**3 + 5, 7), (3 * 2**30 + 1, 2)]:
        assert ct.integer_to_poly(value, order) == cj.integer_to_poly(value, order)
        coeffs = cj.integer_to_poly(value, order)
        assert ct.poly_to_integer(coeffs, order) == cj.poly_to_integer(coeffs, order) == value
        assert ct.poly_to_str(coeffs) == cj.poly_to_str(coeffs)
    for text, order in [("x^8 + x^4 + x^3 + x + 1", 2), ("2x^2 + 3", 5)]:
        assert ct.str_to_integer(text, order) == cj.str_to_integer(text, order)
