"""The plain reference on its own: codes from the configuration files, their
generators, and decodes of the words it encoded (no import of the library)."""

import json
import pathlib

import pytest
import torch

from portbench.reference.cyclic_codes import PRECISIONS, GF2m, code_from_config, syndromes_horner, syndromes_planes
from portbench.traffic import counts, make_batch

HERE = pathlib.Path(__file__).resolve().parent.parent
CELLS = {  # workload: (configuration, mix)
    "rs_ccsds_errors": ("rs255_223_ccsds", "ccsds_errors"),
    "bch_h261_errors": ("bch511_493_h261", "h261_errors"),
    "rs_ccsds_erasures": ("rs255_223_ccsds", "ccsds_erasures"),
}


def load(workload, batch):
    conf, mix = CELLS[workload]
    config = json.loads((HERE / "configs" / f"{conf}.json").read_text())
    mix = {**json.loads((HERE / "mixes" / f"{mix}.json").read_text()), "batch": batch}
    return config, mix


def batch(workload, n_rows, seed):
    config, mix = load(workload, n_rows)
    code = code_from_config(config)
    q = 2 if config["symbols"] == "GF(2)" else 1 << config["m"]
    gen = torch.Generator().manual_seed(seed)
    msg, received, mask, err, era = make_batch(mix, code, q, gen)
    return config, code, msg, received, mask, err, era


def times(a, b):
    """Product of two GF(2) polynomials as bit lists, ascending."""
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] ^= x & y
    return out


def asc(*exps, deg):
    return [1 if e in exps else 0 for e in range(deg + 1)]


def test_bch_generator_is_h261():
    config, _ = load("bch_h261_errors", 1)
    g = code_from_config(config).generator
    assert g == times(asc(9, 4, 0, deg=9), asc(9, 6, 4, 3, 0, deg=9))
    assert g == asc(18, 15, 12, 10, 8, 7, 6, 3, 0, deg=18)


def test_ccsds_generator_roots():
    config, _ = load("rs_ccsds_errors", 1)
    code = code_from_config(config)
    F = code.F
    assert len(code.generator) == 33 and code.generator[-1] == 1
    a11 = F.pow_int(2, 11)
    for j in range(256):
        value = 0
        for coef in reversed(code.generator):
            value = F.mul_int(value, F.pow_int(a11, j)) ^ coef
        assert (value == 0) == (112 <= j <= 143 or 112 <= j + 255 <= 143), j
    assert code.generator == code.generator[::-1]  # CCSDS's generator is palindromic
    assert code.generator[:4] == [1, 91, 127, 86]


def test_field_rejects_a_polynomial_that_is_not_primitive():
    with pytest.raises(ValueError):
        GF2m(8, 0x11B)  # irreducible, but x has order 51


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_counts_are_one_multiset_within_bounds(workload):
    _, mix = load(workload, 4096)
    err, era = counts(mix)
    assert err.min() >= 0 and era.min() >= 0
    if "erasures" in mix:
        assert int(era.max()) == mix["erasures"][1]
        assert bool((2 * err + era <= mix["errors_budget"]).all())
    else:
        assert int(err.max()) == max(mix["errors"][1], mix.get("beyond", {"errors": [0, 0]})["errors"][1])


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_same_counts_for_every_seed(workload):
    a = batch(workload, 96, 1)
    b = batch(workload, 96, 2**31 + 5)
    for x, y in ((a[5], b[5]), (a[6], b[6])):
        assert sorted(x.tolist()) == sorted(y.tolist())
    assert not torch.equal(a[3], b[3])


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_reference_decodes_the_words_it_encoded(workload):
    config, code, msg, received, mask, err, era = batch(workload, 160, 11)
    word = code.encode(msg)
    assert torch.equal(word[:, : code.k], msg)
    assert not bool(syndromes_horner(code.F, word.flip(1), code.roots).any())
    out, n_err = code.decode(received, mask)
    within = 2 * err + era <= code.d - 1
    assert bool(within.any())
    assert torch.equal(out[within], word[within])
    assert torch.equal(n_err[within], err[within])
    beyond = ~within
    if bool(beyond.any()):  # beyond capacity: returned as received, or another codeword
        failed = n_err[beyond] == -1
        assert torch.equal(out[beyond][failed], received[beyond][failed])


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_plane_syndromes_by_precision(workload, precision):
    """float32, TF32 and bfloat16 sums of 0/1 planes are exact here (RS(255,223)'s
    sums are at most 255; BCH(511,493)'s, over 511 positions, stay near 128 for
    random words); float8_e4m3fn's, exact only up to 16, are not."""
    config, code, msg, received, mask, err, era = batch(workload, 64, 3)
    r = received.flip(1)
    exact = syndromes_horner(code.F, r, code.roots)
    got = syndromes_planes(code.F, r, code.roots, precision)
    if precision == "float8_e4m3fn":
        assert not torch.equal(got, exact)
    else:
        assert torch.equal(got, exact)
