"""The port's ``parallel`` package (the sharded NTT and the sharded FEC
decode) against the JAX package's, on the CPU.

One module fixture spawns 4 ranks (``spawn``, a gloo ``FileStore`` under a
temporary directory, one torch thread each) that run every case of
``tests/_torch_parallel_ranks.py`` on the port: on a 1-D ("x",) mesh of 4
and on the "x" dim of a (2, 2) ("y", "x") mesh (D = 2). The ranks import
torch and galois_tpu_torch only. Each rank gathers its shards with
``all_gather`` and sends both to this process, which compares the integers
for exact equality with the JAX package's ``galois_tpu.parallel`` functions
on a mesh of 4 (or 2 x 2) of conftest's 8 virtual CPU devices, with the same
NumPy-seeded inputs: the shards in rank order, every rank's gathered whole
and the JAX package's global array must be the same integers; an error case
must raise the JAX package's exception type with its message (a batch not
divisible by D in ``sharded_decode`` is the exception: JAX's message there
comes from ``jax.device_put``, so only the type is held), and the fallback
must warn as the JAX package does (the other cases must not warn).

JAX's compiles (the BLS12-381 transforms and the RS(255,223) decoders most)
take most of this file's time, so its references are computed in three
parts at once while the ranks run: one here, two in spawned processes
(``_jax_jobs``). Every spawned process is joined with a time limit: on
expiry they are killed and the cases fail.
"""

import multiprocessing
import queue as queue_mod
import time

import numpy as np
import pytest

import galois_tpu as gj
import galois_tpu_torch as gt
from galois_tpu import parallel as jax_parallel
from galois_tpu_torch.parallel import _mesh

from . import _torch_parallel_ranks as ranks_mod

SPAWNED_TIMEOUT_S = 240
# decode's batch check: the JAX package leaves it to jax.device_put, whose message differs
TYPE_ONLY = {"error_decode_b_mod_d"}


def _jax_mesh(D):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    if D == 4:
        return Mesh(np.array(devs[:4]).reshape(4), ("x",))
    return Mesh(np.array(devs[:4]).reshape(2, 2), ("y", "x"))


def _jax_result(case, D, mesh, inputs):
    """The JAX package's result as comparable NumPy: ("ok", ints, n_errors
    ints or None, warnings) or ("raised", type, message)."""
    res = ranks_mod.run_case(gj, jax_parallel, case, D, mesh, inputs)
    if res[0] != "ok":
        return res
    out = res[1]
    if isinstance(out, tuple):
        return ("ok", np.asarray(out[0]), np.asarray(out[1]), res[2])
    return ("ok", np.asarray(out), None, res[2])


def _jax_jobs():
    """The JAX references as three lists of (case, D) of about equal compile
    time: the transforms over GF(3*2^30+1), Goldilocks and BLS12-381 r on
    each mesh, and all the rest. The first runs in the test process (four
    or more parts ran slower: the CPU is the bound)."""
    fft = [c for c in ranks_mod.CASES if c.startswith("fft_") and "fallback" not in c]
    rest = [(c, D) for D in ranks_mod.MESH_SIZES for c in ranks_mod.CASES if c not in fft]
    return [[(c, D) for c in fft] for D in ranks_mod.MESH_SIZES] + [rest]


def jax_refs_main(job, inputs, queue):
    """A spawned process: the JAX package's results of ``job``, a list of
    (case, D), on conftest's virtual devices (its XLA_FLAGS come with the
    environment)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        for case, D in job:
            queue.put(("jax", (case, D), _jax_result(case, D, _jax_mesh(D), inputs)))
    finally:
        queue.put(("jax", None, None))


class _Spawned:
    """Spawned processes and what they sent: (sender, key, value) messages,
    (sender, None, None) when one of them is done."""

    def __init__(self, procs, queue):
        self.procs, self.queue = procs, queue
        self.results, self.n_done, self.error = {}, 0, None
        self.deadline = time.monotonic() + SPAWNED_TIMEOUT_S

    def get(self, sender, key):
        while (sender, key) not in self.results and self.n_done < len(self.procs) and self.error is None:
            try:
                who, k, value = self.queue.get(timeout=max(self.deadline - time.monotonic(), 0.1))
            except queue_mod.Empty:
                self.error = f"the spawned processes did not finish within {SPAWNED_TIMEOUT_S} s"
                self.close()
                break
            if k is None:
                self.n_done += 1
            else:
                self.results[(who, k)] = value
        if (sender, key) not in self.results:
            pytest.fail(f"no result {key} from {sender} ({self.error or 'it stopped'})")
        return self.results[(sender, key)]

    def close(self):
        for p in self.procs:
            p.join(timeout=max(self.deadline - time.monotonic(), 0.1))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The 4 ranks and two JAX reference processes, started together; the
    first JAX job runs here meanwhile."""
    with gt.default_device("cpu"):
        inputs = ranks_mod.make_inputs(gt)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    here, *jobs = _jax_jobs()
    procs = [
        ctx.Process(target=ranks_mod.rank_main, args=(r, store, inputs, q), daemon=True)
        for r in range(ranks_mod.WORLD)
    ] + [ctx.Process(target=jax_refs_main, args=(job, inputs, q), daemon=True) for job in jobs]
    for p in procs:
        p.start()
    handle = _Spawned(procs, q)
    try:
        handle.results.update({("jax", (c, D)): _jax_result(c, D, _jax_mesh(D), inputs) for c, D in here})
        yield handle
    finally:
        handle.close()


def _same(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(object), want.astype(object))


@pytest.mark.parametrize("D", ranks_mod.MESH_SIZES)
@pytest.mark.parametrize("case", list(ranks_mod.CASES))
def test_sharded_matches_jax(spawned, case, D):
    want = spawned.get("jax", (case, D))
    got = [spawned.get(("rank", r), (case, D)) for r in range(ranks_mod.WORLD)]
    for r, res in enumerate(got):
        assert res[0] != "failed", f"rank {r}:\n{res[1]}"
        if want[0] == "raised":
            assert res[:2] == want[:2], f"rank {r}: {res}"
            if case not in TYPE_ONLY:
                assert res[2] == want[2]
            continue
        assert res[0] == "ok", f"rank {r}: {res}"
        (_, whole), errs, said = res[1], res[2], res[3]
        _same(whole, want[1])
        if errs is not None:
            _same(errs[1], want[2])
        assert said == want[3]
    if want[0] == "ok":
        # the shards in rank order along the mesh dim "x" (coordinate r % D on
        # either mesh) make the whole; on the 2 x 2 mesh both rows of ranks
        # hold the same shards
        for part in (1, 2):
            if want[part] is None:
                continue
            _same(np.concatenate([got[r][part][0] for r in range(D)]), want[part])
            for r in range(D, ranks_mod.WORLD):
                _same(got[r][part][0], got[r % D][part][0])


def test_ranks_import_no_jax(spawned):
    """The ranks ran the port with torch alone: no jax, jaxlib or galois_tpu."""
    for r in range(ranks_mod.WORLD):
        assert spawned.get(("rank", r), "jax modules") == []


def test_cuda_mesh_needs_a_card(monkeypatch):
    """A 'cuda' mesh without a card raises; nothing falls back to the CPU."""

    class CudaMesh:
        device_type = "cuda"

    monkeypatch.setattr(_mesh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        _mesh.mesh_device(CudaMesh())
