"""The mesh side of the sharded functions: a rank's device, its place on a
mesh dim, its shard of a whole array, and the two collectives they use.

Every collective moves its tensor as a same-bits ``uint8`` view: neither
gloo nor NCCL takes ``int16`` or ``uint16`` (gloo raises "Invalid scalar
type"), and planar limb storage is ``uint16``. The views are taken on
contiguous buffers and viewed back, so no data leaves the rank's device
on the package's account (gloo stages CUDA tensors through host memory
itself).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renamed all_gather_into_tensor (kept, deprecated) to all_gather_single
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def mesh_device(mesh) -> torch.device:
    """The rank's device for the mesh's device type: the current CUDA card
    for a ``"cuda"`` mesh (which raises without one), else the CPU."""
    if mesh.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("A 'cuda' mesh needs a CUDA card, and none is available.")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_info(mesh, axis: str):
    """(process group, size D, this rank's coordinate r) of the mesh dim ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def local_shard(data: torch.Tensor, dim: int, D: int, r: int, device) -> torch.Tensor:
    """Rank r's D-th of ``data`` along ``dim``, on ``device``."""
    n = data.shape[dim] // D
    return data.narrow(dim, r * n, n).to(device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def all_to_all(blocks: torch.Tensor, group) -> torch.Tensor:
    """``blocks``: (D, ...); block e goes to rank e. Returns (D, ...) whose
    block j came from rank j (``jax.lax.all_to_all``, untiled, split and
    concatenated on axis 0)."""
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(_bytes(out), _bytes(blocks), group=group)
    return out


def all_gather(local: torch.Tensor, group, D: int) -> torch.Tensor:
    """(D, *local.shape): every rank's ``local``, in rank order."""
    local = local.contiguous()
    out = torch.empty((D,) + tuple(local.shape), dtype=local.dtype, device=local.device)
    _all_gather_single(_bytes(out), _bytes(local), group=group)
    return out
