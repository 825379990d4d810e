"""Multi-process data parallelism: per-rank input sharding, the process
group, and the collectives the steps and trainers use (counterpart of
`qea_ocr_tpu/parallel/multihost.py` and `utils/platform.py`'s
`maybe_init_distributed`).

PyTorch runs one process per GPU, so the port's `data_parallel` is the JAX
package's multi-process path on every world size:

  * every rank loads only its slice of each global document batch
    (`shard_indices_for_host` / `batch_iterator(host_shard=...)`), or a
    pinned subset of the documents (`pinned_subset`);
  * each rank runs the black-box OCR for its own strips, and the query
    ledger is summed over ranks (`process_sum`);
  * the device math is still one step over the *global* batch, as GSPMD
    gives it in JAX. That is not what `DistributedDataParallel` computes, so
    the steps run inside `data_group(group)`, and the functions below make
    each normalising count global (`global_count`), each train-mode batch
    norm use global statistics (`global_sum_grad`), and the per-strip tables
    see every rank's rows (`gather_rows`). Each rank's loss is then
    `local_sum / global_count`, and the gradients are *summed* over the
    group (`sum_gradients`), which is the gradient of the global loss.

Outside `data_group` (or with no process group at all) every function here
is the identity, so the single-process steps are unchanged. Each
collective that a step issues (`global_count`, `global_sum_grad`,
`gather_rows`, `sum_gradients`) runs in a span named `collective`.

The backend follows the device, explicitly: NCCL for CUDA, Gloo for the
CPU. A CUDA run never takes Gloo, and a missing NCCL raises.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from qea_ocr_tpu_torch.utils.metrics import span

# ------------------------------------------------------------ host functions


def process_shard(process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> Tuple[int, int]:
    """(process_index, process_count), defaulting to the process group's
    rank and world size ((0, 1) without a group)."""
    on = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if on else 0
    if process_count is None:
        process_count = dist.get_world_size() if on else 1
    return int(process_index), int(process_count)


def local_batch_size(global_batch_size: int, process_count: int) -> int:
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{process_count} processes")
    return global_batch_size // process_count


def shard_indices_for_host(indices: np.ndarray, global_batch_size: int,
                           process_index: int, process_count: int) -> np.ndarray:
    """This rank's rows of every global batch, in step order.

    `indices` is the epoch's (already shuffled, identically on every rank)
    global index sequence. It is cut into windows of `global_batch_size`
    (a trailing partial window is dropped: the ranks step in lockstep, so
    every rank must see the same step count) and rank p takes the p-th
    contiguous `Dl` rows of each window. Iterating the result with a local
    batch size of `Dl` yields exactly this rank's slice of each global step
    batch.
    """
    dl = local_batch_size(global_batch_size, process_count)
    indices = np.asarray(indices)
    steps = len(indices) // global_batch_size
    windows = indices[:steps * global_batch_size].reshape(
        steps, global_batch_size)
    return windows[:, process_index * dl:(process_index + 1) * dl].reshape(-1)


def pinned_subset(indices: np.ndarray, process_index: int,
                  process_count: int) -> np.ndarray:
    """Static per-rank partition of a dataset index list (round-robin),
    trimmed so every rank owns the same count (the ranks step in
    lockstep). Pinning documents to ranks keeps host-side state (label
    history, selection bookkeeping, OCR fan-out) consistent across epochs
    without any exchange: a rank only ever queries and tracks its own
    documents."""
    indices = np.asarray(indices)
    n = len(indices) // process_count
    return indices[process_index::process_count][:n]


# ------------------------------------------------------------ process group

def _env_on() -> bool:
    return os.environ.get("QEA_DISTRIBUTED", "").strip().lower() in (
        "1", "true")


def backend_for(device: str | torch.device) -> str:
    """The collective backend for `device`: NCCL for CUDA, Gloo for the
    CPU. Raises where that backend is missing; never gives another."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        if not dist.is_nccl_available():
            raise RuntimeError(
                "a CUDA process group needs NCCL, and this torch has none "
                "(the port does not fall back to Gloo)")
        return "nccl"
    if dev.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a CPU process group needs Gloo")
        return "gloo"
    raise ValueError(f"unsupported device {device!r}: use cpu or cuda")


def local_rank() -> int:
    """This process's index on its machine: torchrun's `LOCAL_RANK`, else
    the global rank modulo the visible GPUs."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else int(
        os.environ.get("QEA_PROCESS_ID", os.environ.get("RANK", "0")))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(1, n)


def maybe_init_distributed(device: str | torch.device = "cuda") -> bool:
    """Opt-in multi-process runtime for the CLI entry points; returns
    whether a process group exists afterwards.

    The group is made when `QEA_DISTRIBUTED=1` (with `QEA_COORDINATOR`
    host:port, `QEA_NUM_PROCESSES` and `QEA_PROCESS_ID`, the JAX package's
    variables), or when torchrun's `RANK` and `WORLD_SIZE` are set (its
    `MASTER_ADDR` / `MASTER_PORT` give the address). Its backend follows
    `device` (`backend_for`); on CUDA rank r binds `cuda:LOCAL_RANK`.
    Idempotent: a group that exists is kept, but one whose backend does not
    match `device` raises."""
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (dist.is_initialized() or _env_on() or torchrun):
        return False
    want = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"a {have} process group exists, but device "
                               f"{device!r} needs {want}")
        return True
    if os.environ.get("QEA_COORDINATOR"):
        kw = dict(init_method=f"tcp://{os.environ['QEA_COORDINATOR']}",
                  world_size=int(os.environ["QEA_NUM_PROCESSES"]),
                  rank=int(os.environ["QEA_PROCESS_ID"]))
    elif torchrun:
        kw = dict(init_method="env://")
    else:
        raise ValueError("QEA_DISTRIBUTED=1 needs QEA_COORDINATOR (host:port), "
                         "QEA_NUM_PROCESSES and QEA_PROCESS_ID, or torchrun's "
                         "RANK and WORLD_SIZE")
    if want == "nccl":
        index = local_rank()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend=want, **kw)
    return True


def rank_device(device: str | torch.device) -> torch.device:
    """`device` as this rank uses it: a bare `cuda` under a process group is
    `cuda:LOCAL_RANK`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return dev


def comm_device(group=None) -> torch.device:
    """Where a tensor must lie for a collective over `group`."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_sum(values, group=None) -> np.ndarray:
    """Element-wise sum of a small host array across the ranks of `group`
    (the world by default), e.g. the per-epoch black-box call ledger.
    Identity under one process."""
    arr = np.asarray(values, np.float64)
    if _world(group) == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(comm_device(group))
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


def broadcast_object(obj: Any, group, src_index: int = 0) -> Any:
    """`obj` of the rank at `src_index` within `group`, on every rank of
    it (the others pass anything)."""
    if _world(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, group_src=src_index, group=group,
        device=comm_device(group))
    return box[0]


def all_gather_objects(obj: Any, group=None) -> list:
    """Every rank's `obj`, in rank order."""
    if _world(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ------------------------------------------ rows: local <-> global batches

def global_from_local(local: Any, device: str | torch.device
                      ) -> torch.Tensor:
    """This rank's rows of a global batch on its device. Where JAX
    assembles a global array from the local rows, a rank here keeps its own
    rows: the steps read global values through the collectives below."""
    return torch.from_numpy(np.ascontiguousarray(local)).to(device)


def global_from_local_dim(local: Any, device: str | torch.device,
                          dim: int) -> torch.Tensor:
    """`global_from_local` for a batch sharded on `dim` (jitter stacks are
    (n_jitter, N, ...)): the same, as the rank keeps its rows whatever
    their axis."""
    del dim
    return global_from_local(local, device)


def put_batch_global(tree: Any, device: str | torch.device) -> Any:
    """Every numpy leaf of a batch (a dict, list or tuple of them, or one)
    as this rank's rows on its device."""
    if isinstance(tree, dict):
        return {k: put_batch_global(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(put_batch_global(v, device) for v in tree)
    return global_from_local(tree, device)


def local_rows(x: Any) -> np.ndarray:
    """This rank's rows of a batch-sharded device value, on the host: the
    whole tensor, since a rank only ever holds its own rows."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -------------------------------------------- the data group of the steps

_active: list = []     # the stack of data groups set by `data_group`


@contextlib.contextmanager
def data_group(group):
    """Inside the block the step functions compute over the global batch of
    `group` (a `ProcessGroup`, e.g. `dist.group.WORLD`; None leaves them
    single-process): normalising counts, batch statistics and table updates
    are global."""
    _active.append(group)
    try:
        yield
    finally:
        _active.pop()


def in_data_group(group, fn):
    """`fn`, run inside `data_group(group)` at every call."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with data_group(group):
            return fn(*args, **kwargs)
    return run


def current_group():
    """The innermost `data_group`'s group, or None."""
    return _active[-1] if _active else None


def global_count(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the current data group, without a gradient (a count
    or any other quantity a loss divides by). Identity without one."""
    group = current_group()
    if group is None:
        return x
    out = x.detach().clone()
    with span("collective"):
        dist.all_reduce(out, group=group)
    return out


def global_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the current data group through an autograd
    all-reduce: the backward sums the upstream gradients of all ranks (the
    batch statistics of a train-mode batch norm). Identity without one."""
    group = current_group()
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    with span("collective"):
        return all_reduce(x, group=group)


def global_numel(n: int) -> int:
    """A local element count made global: every rank of the data group
    steps in lockstep on tensors of the same shapes, so it is the local
    count times the group's size (no collective). Identity without one."""
    group = current_group()
    return n if group is None else n * dist.get_world_size(group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()` over the global batch: this rank's sum over the global
    element count (the rank's share of the global mean)."""
    if current_group() is None:
        return x.mean()
    return x.sum() / global_numel(x.numel())


def reported(loss: torch.Tensor) -> torch.Tensor:
    """A loss for the host to read: the sum of every rank's share, i.e. the
    global loss, the same on every rank."""
    return global_count(loss.detach())


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank of the current data group, concatenated in
    rank order along dim 0 (every rank holds as many). Identity without
    one."""
    group = current_group()
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with span("collective"):
        dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def sum_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum each plain-tensor parameter's `.grad` over the current data group
    in one flat all-reduce. Gradients of `DTensor` parameters are left
    alone: their fully-sharded module has reduced them already."""
    group = current_group()
    if group is None or dist.get_world_size(group) == 1:
        return
    from torch.distributed.tensor import DTensor
    grads = [p.grad for p in params
             if p.grad is not None and not isinstance(p, DTensor)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    with span("collective"):
        dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
