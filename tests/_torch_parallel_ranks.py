"""The cases of ``tests/test_torch_parallel.py`` and the rank processes that
run them on the port.

A rank imports torch and galois_tpu_torch only, never jax: it is started by
the ``spawn`` method and imports this module, not the test file. The cases
are written once, for either package: ``run_case(pkg, parallel, case, D,
mesh, inputs)`` calls ``parallel.sharded_fft`` and the rest the same way in
both, on the fields and codes ``MAKERS`` builds; the test runs it
with the JAX package on a ``jax.sharding.Mesh``, each rank with the port on
a ``DeviceMesh``, where the result is this rank's shard.
"""

from __future__ import annotations

import datetime
import sys
import traceback
import warnings

import numpy as np

BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
WORLD = 4
MESH_SIZES = (4, 2)  # a ("x",) mesh of 4; the "x" dim of a ("y", "x") mesh of 2 x 2

MAKERS = {
    "p": lambda g: g.GF(3 * 2**30 + 1),
    "gold": lambda g: g.GF(2**64 - 2**32 + 1),
    "bls": lambda g: g.GF(BLS_R, primitive_element=7, verify=False),
    "rs15": lambda g: g.ReedSolomon(15, 11),
    "rs255": lambda g: g.ReedSolomon(255, 223),
    "bch15": lambda g: g.BCH(15, 7),
    "rs15_d1": lambda g: g.ReedSolomon(15, 15),
    "rs15_nonsys": lambda g: g.ReedSolomon(15, 11, systematic=False),
}

# name -> (function, what it runs on, input key, keyword arguments). Inputs
# named by a dict take the entry of the mesh size D.
CASES = {
    "fft_p": ("fft", "p", "x_p", {}),
    "fft_p_inverse": ("fft", "p", "x_p", {"inverse": True}),
    "fft_gold": ("fft", "gold", "x_gold", {}),
    "fft_gold_inverse": ("fft", "gold", "x_gold", {"inverse": True}),
    "fft_bls": ("fft", "bls", "x_bls", {}),
    "fft_bls_inverse": ("fft", "bls", "x_bls", {"inverse": True}),
    # D | N, D^2 not: N = 8 at D = 4, 6 at D = 2; warns
    "fft_fallback": ("fft", "p", {4: "x_p8", 2: "x_p6"}, {}),
    "fft_fallback_inverse": ("fft", "p", {4: "x_p8", 2: "x_p6"}, {"inverse": True}),
    "batched": ("batched", "p", "x_batch", {}),
    "batched_inverse": ("batched", "p", "x_batch", {"inverse": True}),
    "rs15": ("decode", "rs15", "rs15", {}),
    "rs15_message": ("decode", "rs15", "rs15", {"output": "message"}),
    "rs15_erasures_shortened": ("decode", "rs15", "rs15_short", {"erasures": "rs15_short_era"}),
    "rs15_erasures_shortened_message": (
        "decode", "rs15", "rs15_short", {"erasures": "rs15_short_era", "output": "message"}),
    "rs255": ("decode", "rs255", "rs255", {}),
    "rs255_message": ("decode", "rs255", "rs255", {"output": "message"}),
    "rs255_erasures_shortened": ("decode", "rs255", "rs255_short", {"erasures": "rs255_short_era"}),
    "rs255_erasures_shortened_message": (
        "decode", "rs255", "rs255_short", {"erasures": "rs255_short_era", "output": "message"}),
    "bch15": ("decode", "bch15", "bch15", {}),
    "bch15_message": ("decode", "bch15", "bch15", {"output": "message"}),
    "d1_identity": ("decode", "rs15_d1", "rs15_d1", {"output": "message"}),
    # the error cases: each raises before any collective, on every rank alike
    "error_fft_n_mod_d": ("fft", "p", "x_p3", {}),
    "error_batched_b_mod_d": ("batched", "p", "x_batch3", {}),
    "error_decode_b_mod_d": ("decode", "rs15", "rs15_b3", {}),
    "error_decode_ns": ("decode", "rs15", "rs15_ns3", {}),
    "error_decode_symbols": ("decode", "rs15", "rs15_bad_symbol", {}),
    "error_decode_erasure_dtype": ("decode", "rs15", "rs15", {"erasures": "era_int"}),
    "error_decode_erasure_shape": ("decode", "rs15", "rs15", {"erasures": "era_short"}),
    "error_decode_message_nonsystematic": ("decode", "rs15_nonsys", "rs15_nonsys", {"output": "message"}),
    "error_output": ("decode", "rs15", "rs15", {"output": "bits"}),
}


def make_inputs(gt) -> dict:
    """The inputs, NumPy from seeds; codewords by the port's encoder (on the
    CPU), corrupted in NumPy."""
    rng = np.random.default_rng(2026)
    p, gold = 3 * 2**30 + 1, 2**64 - 2**32 + 1
    inp = {
        "x_p": rng.integers(0, p, 2**12),
        "x_gold": np.array([(int(a) << 32 | int(b)) % gold for a, b in rng.integers(0, 2**32, (1024, 2))], dtype=object),
        "x_bls": np.array([int.from_bytes(rng.bytes(32), "little") % BLS_R for _ in range(256)], dtype=object),
        "x_p8": rng.integers(0, p, 8),
        "x_p6": rng.integers(0, p, 6),
        "x_p3": rng.integers(0, p, 3),
        "x_batch": rng.integers(0, p, (8, 64)),
        "x_batch3": rng.integers(0, p, (3, 64)),
    }

    def words(code, rows, ns, n_err, n_era=0):
        ks = code.k - (code.n - ns)
        msg = rng.integers(0, code.field.order, (rows, ks))
        cw = np.asarray(code.encode(code.field(msg)), dtype=np.int64)
        era = np.zeros(cw.shape, dtype=bool)
        for i in range(rows):
            pos = rng.permutation(ns)
            bad = pos[: n_err + (i % 2)]  # every other row one error more
            cw[i, bad] ^= rng.integers(1, code.field.order, bad.size)
            era[i, pos[n_err + 1 : n_err + 1 + n_era]] = True
            cw[i, era[i]] = 0
        return cw, era

    rs15, rs255, bch15 = (MAKERS[k](gt) for k in ("rs15", "rs255", "bch15"))
    inp["rs15"], _ = words(rs15, 8, 15, 1)
    inp["rs15_short"], inp["rs15_short_era"] = words(rs15, 8, 13, 0, 2)  # 2e + f <= 4
    inp["rs255"], _ = words(rs255, 8, 255, 15)  # rows of 16 errors: t = 16
    inp["rs255"][7, :20] ^= 1  # a row beyond the capability: -1 or a codeword
    inp["rs255_short"], inp["rs255_short_era"] = words(rs255, 8, 200, 7, 16)  # 2e + f <= 32
    inp["bch15"], _ = words(bch15, 8, 15, 1)  # t = 2
    inp["rs15_d1"] = rng.integers(0, 16, (8, 15))
    inp["rs15_nonsys"] = np.asarray(
        MAKERS["rs15_nonsys"](gt).encode(rs15.field(rng.integers(0, 16, (8, 11)))), dtype=np.int64)
    inp["rs15_ns3"] = inp["rs15"][:, :3]
    inp["rs15_b3"] = inp["rs15"][:3]
    inp["rs15_bad_symbol"] = inp["rs15"].copy()
    inp["rs15_bad_symbol"][3, 4] = 16
    inp["era_int"] = np.zeros((8, 15), dtype=np.int64)
    inp["era_short"] = np.zeros((8, 14), dtype=bool)
    return inp


def run_case(pkg, parallel, case: str, D: int, mesh, inputs: dict):
    """Run ``case`` through ``parallel`` on ``mesh`` (its mesh dim "x" of
    size D). Returns ("ok", the function's result, the RuntimeWarnings it
    raised as (category, message) pairs) or ("raised", exception type name,
    message)."""
    fn, target, key, kwargs = CASES[case]
    obj = MAKERS[target](pkg)
    kwargs = dict(kwargs)
    x = inputs[key[D] if isinstance(key, dict) else key]
    if "erasures" in kwargs:
        kwargs["erasures"] = inputs[kwargs["erasures"]]
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if fn == "fft":
                out = parallel.sharded_fft(obj, obj(x), mesh, "x", **kwargs)
            elif fn == "batched":
                out = parallel.sharded_batched_fft(obj, obj(x), mesh, "x", **kwargs)
            else:
                out = parallel.sharded_decode(obj, x, mesh, "x", **kwargs)
    except (ValueError, TypeError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))
    return ("ok", out, [(w.category.__name__, str(w.message)) for w in caught if issubclass(w.category, RuntimeWarning)])


def _ints(field_cls, data, group, D, dim):
    """(this rank's ints, the gathered whole's ints): the shard along
    ``dim``, gathered with all_gather in rank order."""
    from galois_tpu_torch.parallel._mesh import all_gather

    whole = all_gather(data, group, D).movedim(0, dim)
    whole = whole.reshape(tuple(data.shape[:dim]) + (D * data.shape[dim],) + tuple(data.shape[dim + 1 :]))
    if field_cls is None:
        return data.numpy(), whole.numpy()
    return np.asarray(field_cls._view(data)), np.asarray(field_cls._view(whole))


def rank_main(rank: int, store_path: str, inputs: dict, queue) -> None:
    """One of the WORLD ranks: every case on both meshes, each result put on
    ``queue`` as (("rank", rank), (case, D), result) when it is ready, then
    the JAX modules it imported (none); (("rank", rank), None, None) when
    all are done."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        import galois_tpu_torch as gt
        from galois_tpu_torch import parallel

        gt.set_default_device("cpu")
        meshes = {
            4: init_device_mesh("cpu", (4,), mesh_dim_names=("x",)),
            2: init_device_mesh("cpu", (2, 2), mesh_dim_names=("y", "x")),
        }
        for D, mesh in meshes.items():
            group = mesh.get_group("x")
            for case in CASES:
                try:
                    res = run_case(gt, parallel, case, D, mesh, inputs)
                    if res[0] == "ok":
                        out = res[1]
                        if CASES[case][0] == "decode":
                            dec, n_err = out
                            res = ("ok", _ints(type(dec), dec._data, group, D, 0), _ints(None, n_err, group, D, 0), res[2])
                        else:
                            F = type(out)
                            lead = 1 if F._meta.storage_first else 0
                            res = ("ok", _ints(F, out._data, group, D, lead), None, res[2])
                except Exception:  # reported to the parent, which fails the case
                    res = ("failed", traceback.format_exc())
                queue.put((("rank", rank), (case, D), res))
        jaxish = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "galois_tpu"))
        queue.put((("rank", rank), "jax modules", jaxish))
    finally:
        queue.put((("rank", rank), None, None))
        dist.destroy_process_group()
