"""Device mesh and the placement of replicated state (counterpart of
`qea_ocr_tpu/parallel/mesh.py`).

The JAX package replicates the states over a 1-D `data` mesh and lets GSPMD
partition each step. Here each rank holds a full copy of the models and
optimizers; `put_replicated` makes those copies equal to rank 0's, and the
steps keep them equal by summing the gradients over the group
(`multihost.sum_gradients`), so every rank applies the same update.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from qea_ocr_tpu_torch.parallel.multihost import comm_device

DATA_AXIS = "data"


def mesh_device_type() -> str:
    """The mesh's device type, from the process group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: Optional[int] = None,
              axis: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D mesh named `axis` over the whole world (one device a rank)."""
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices in a world of "
                         f"{world} processes")
    return init_device_mesh(mesh_device_type(), (world,),
                            mesh_dim_names=(axis,))


def replicated(mesh: DeviceMesh) -> list:
    """The placements of a replicated value."""
    return [Replicate()] * mesh.ndim


def batch_sharding(mesh: DeviceMesh, axis: str = DATA_AXIS) -> list:
    """The placements of a batch sharded on its leading axis over `axis`."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    """`t` of global rank `src`, in place; a tensor on the CPU travels
    over NCCL through the rank's GPU."""
    dev = comm_device(group)
    if t.device == dev:
        dist.broadcast(t, src=src, group=group)
        return
    tmp = t.detach().to(dev)
    dist.broadcast(tmp, src=src, group=group)
    t.copy_(tmp.to(t.device))


def put_replicated(obj: Any, mesh: DeviceMesh,
                   axis: str = DATA_AXIS) -> Any:
    """Make `obj` on every rank of `mesh`'s `axis` equal to its first
    rank's, in place, and return it: an `nn.Module` (parameters and
    buffers), an optimizer (its state tensors) or a tensor."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    if dist.get_world_size(group) == 1:
        return obj
    with torch.no_grad():
        if isinstance(obj, torch.nn.Module):
            tensors = [*obj.parameters(), *obj.buffers()]
        elif isinstance(obj, torch.optim.Optimizer):
            tensors = [v for state in obj.state.values()
                       for v in state.values() if isinstance(v, torch.Tensor)]
        else:
            tensors = [obj]
        for t in tensors:
            _broadcast(t.data, src, group)
    return obj


def put_batch(tree: Any, mesh: DeviceMesh, axis: str = DATA_AXIS) -> Any:
    """This rank's slice of a global batch: rows [r*n/w, (r+1)*n/w) of every
    leaf (numpy array or tensor; a dict, list or tuple of them), where r is
    the rank's coordinate on `axis` and w the axis size."""
    if isinstance(tree, dict):
        return {k: put_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(put_batch(v, mesh, axis) for v in tree)
    w = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    n = tree.shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} rows over {w} ranks")
    out = tree[r * n // w:(r + 1) * n // w]
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) else out
