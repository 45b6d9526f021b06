"""Multi-device functions on ``torch.distributed``: the port of
``galois_tpu/parallel/``.

Public surface:

- ``sharded_fft(field, x, mesh, axis)`` — 4-step NTT with the stage
  exchanges as ``all_to_all`` over the mesh dim, for 1-D inputs whose
  length admits a D x D split; falls back to a replicated local plan
  (``all_gather``, with a RuntimeWarning) otherwise.
- ``sharded_batched_fft`` — batch axis sharded over the ranks, transform
  axis local (embarrassingly parallel; the common FEC/polynomial-batch shape).
- ``ShardedFFTPlan`` — the cached plan object behind ``sharded_fft``.
- ``sharded_decode(code, received, mesh, axis)`` — batched BCH/RS decode
  with the codeword axis sharded over the mesh (embarrassingly parallel).

A JAX ``Mesh`` and axis name become a ``torch.distributed.device_mesh.
DeviceMesh`` and a mesh dim name; ``shard_map`` becomes SPMD: every rank
calls the same function with the same arguments, the whole array on every
rank, and gets back its own shard (``_ntt_sharded.py`` states the layout).

The single-device analogue is ``ops/_ntt.py``; the reference's (host-only)
staged-loop kernel is src/galois/_domains/_function.py:170-384.
"""

from ._fec_sharded import sharded_decode
from ._ntt_sharded import ShardedFFTPlan, sharded_batched_fft, sharded_fft

__all__ = ["sharded_fft", "sharded_batched_fft", "ShardedFFTPlan", "sharded_decode"]
