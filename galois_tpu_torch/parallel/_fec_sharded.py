"""Mesh-sharded FEC decode: the batch (codeword) axis over the ranks.

Port of ``galois_tpu/parallel/_fec_sharded.py``. Decoding is embarrassingly
parallel across codewords — the reference's per-codeword batch loop
(src/galois/_codes/_bch.py:1347) — so every rank runs the batched decoder
(``codes/_decoder.py::make_decoder``) on its own rows, with no collective.
The convenience ``code.decode`` path returns its error counts through host
NumPy; this one keeps the rank's shard and counts on its device.

SPMD, as the sharded NTT (``_ntt_sharded.py``): every rank calls
``sharded_decode`` with the same arguments, ``received`` (and ``erasures``)
whole on every rank; the result is this rank's rows [r B/D, (r+1) B/D) of
the decoded words and of ``n_errors``, r the rank's coordinate on the mesh
dim ``axis`` and D its size, on the rank's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes._decoder import make_decoder
from ..fields._array import FieldArray
from ..ops._kernels import kernel_mode
from ._mesh import axis_info, local_shard, mesh_device

__all__ = ["sharded_decode"]


def _raw_decoder(code, ns: int, with_erasures: bool):
    """The fixed-shape decoder for ``code`` at received length ns.

    Mirrors BCH/RS ``_decode_codeword`` (codes/_bch.py, codes/_rs.py);
    syndrome arithmetic runs in the extension field for BCH and in the
    symbol field for RS."""
    ext = getattr(code, "extension_field", None) or code.field
    return ext, make_decoder(
        ext._meta,
        kernel_mode(ext),
        code.field.order,
        ns,
        code.n,
        code.d,
        code.c,
        int(code.alpha),
        with_erasures=with_erasures,
    )


def sharded_decode(code, received, mesh, axis: str = "x", output: str = "codeword", erasures=None):
    """Decode a (B, ns) batch with B sharded over ``mesh[axis]``.

    Returns ``(decoded, n_errors)``: this rank's rows of the corrected
    codewords (``output="codeword"``) or, for systematic codes, of the
    recovered messages (``output="message"``), as a FieldArray, and its
    rows of the int64 error counts, -1 where correction failed, matching
    ``code.decode(..., errors=True)``. ``erasures`` is the same boolean
    (B, ns) mask ``code.decode`` takes; it is sharded alongside the
    received batch.
    """
    if output not in ("codeword", "message"):
        raise ValueError(f"Argument 'output' must be 'codeword' or 'message', not {output!r}.")
    field = code.field
    raw = not isinstance(received, FieldArray)
    if raw:
        data = received if torch.is_tensor(received) else torch.from_numpy(np.asarray(received, dtype=np.int64))
        data = data.to(torch.int64)
    else:
        data = received._data.to(torch.int64)
    if data.ndim != 2:
        raise ValueError(f"Argument 'received' must be 2-D (batch, ns), not {data.ndim}-D.")
    ns = data.shape[-1]
    # same ns validation as code.decode (codes/_linear.py): full length for
    # non-systematic codes, [n-k+1, n] for shortened systematic ones
    min_ns = code.n - code.k + 1 if code.is_systematic else code.n
    if not (min_ns <= ns <= code.n):
        raise ValueError(
            f"Argument 'received' must have last dimension in [{min_ns}, {code.n}], not {ns}."
        )
    if raw and (int(data.min()) < 0 or int(data.max()) >= code.field.order):
        raise ValueError(
            f"Argument 'received' must contain symbols in [0, {code.field.order}), "
            f"found range [{int(data.min())}, {int(data.max())}]."
        )
    _, D, r = axis_info(mesh, axis)
    if data.shape[0] % D:
        raise ValueError(f"Batch {data.shape[0]} must be divisible by the mesh axis size {D}.")
    device = mesh_device(mesh)
    local = local_shard(data, 0, D, r, device)
    if code.d <= 1:
        # d = 1: no correction capability — decode is the identity
        out = local.to(field._meta.torch_dtype)
        n_errors = torch.zeros(local.shape[0], dtype=torch.int64, device=device)
    else:
        if erasures is not None:
            emask = erasures if torch.is_tensor(erasures) else torch.from_numpy(np.asarray(erasures))
            if emask.dtype != torch.bool or tuple(emask.shape) != tuple(data.shape):
                raise ValueError(
                    "Argument 'erasures' must be a boolean mask with the received batch's shape."
                )
            emask = local_shard(emask, 0, D, r, device)
        else:
            emask = None
        ext, decoder = _raw_decoder(code, ns, with_erasures=emask is not None)
        out, n_errors = decoder(local.to(ext._meta.torch_dtype), emask)
        out = (out.to(torch.int64) % field.order).to(field._meta.torch_dtype)
    if output == "message":
        if not code.is_systematic:
            raise ValueError("output='message' requires a systematic code.")
        ks = code.k - (code.n - ns)  # shortened message length
        out = out[..., :ks]
    return field._view(out, None), n_errors
