"""Sharded parameter storage over a 2-D (data x model) mesh (counterpart of
`qea_ocr_tpu/parallel/tp.py`).

The JAX package lays each parameter leaf out over a `model` mesh axis with
a `PartitionSpec` and lets GSPMD insert the gathers: layout only, the math
unchanged, the ZeRO / weight-sharded regime. The PyTorch idiom for that
regime is FSDP2: `put_tp` applies `fully_shard` on the 2-D mesh, replicated
over `data` and sharded over `model`, so parameters and Adam moments are
*stored* as `DTensor` shards and each forward gathers them whole.

  * `tp_spec` is the JAX rule on the tensor's own shape: shard the trailing
    axis when it divides by `n_model` into at least `min_shard` elements,
    else replicate. In torch's layouts the trailing axis of a conv weight is
    its kernel width, so the convs stay replicated and the LSTM and linear
    weights, biases and batch-norm vectors are sharded.
  * A parameter the rule replicates is left out of the sharded group
    (`ignored_params`): a plain tensor, its gradient summed over `data` by
    the step (`multihost.sum_gradients`).
  * The gradient of a sharded parameter is reduced by FSDP over the whole
    mesh; the ranks of one model group hold the same documents, so that is
    `n_model` times the sum over `data`, and the divide factor is set to
    `n_model`: the result is the sum the data-parallel steps use.

A module under `fully_shard` holds its parameters whole only inside its
own `forward`. `unsharded` lends them out, as plain tensors, to code that
reads them elsewhere: the UNet's no-grad twin on the conv kernel.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from qea_ocr_tpu_torch.parallel.mesh import DATA_AXIS, mesh_device_type

MODEL_AXIS = "model"


def make_mesh_2d(n_data: int, n_model: int) -> DeviceMesh:
    """A ("data", "model") mesh over the world: rank r sits at data index
    r // n_model and model index r % n_model, so a model group is
    `n_model` consecutive ranks (on one machine, the fastest links)."""
    return init_device_mesh(mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def tp_spec(x: Any, n_model: int, min_shard: int = 2):
    """The placement of `x` over the model axis: `Shard(ndim - 1)` for a
    trailing axis divisible by `n_model` into at least `min_shard`
    elements, `Replicate()` otherwise (scalars, odd vocabulary heads, tiny
    vectors: cheaper replicated than gathered)."""
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) == 0:
        return Replicate()
    last = shape[-1]
    if last % n_model != 0 or last // n_model < min_shard:
        return Replicate()
    return Shard(len(shape) - 1)


def put_tp(model: nn.Module, mesh: DeviceMesh,
           optimizer: Optional[torch.optim.Optimizer] = None,
           min_shard: int = 2) -> nn.Module:
    """Shard `model`'s parameters over `mesh`'s model axis by `tp_spec`
    (`fully_shard`, in place) and return it. Every rank must hold the same
    values first (`mesh.put_replicated`).

    An `optimizer` over the model's plain parameters is moved onto the
    sharded ones: its parameter groups are rebound, and any state it has
    (moments of a resumed run) is cut into the same shards."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import distribute_tensor

    n_model = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    names = [n for n, _ in model.named_parameters()]
    before = list(model.parameters())
    ignored = {p for p in before
               if isinstance(tp_spec(p, n_model, min_shard), Replicate)}
    fully_shard(model, mesh=mesh, ignored_params=ignored or None,
                shard_placement_fn=lambda p: tp_spec(p, n_model, min_shard))
    model.set_gradient_divide_factor(float(n_model))
    if optimizer is not None:
        after = dict(model.named_parameters())
        new_of = {id(p): after[n] for n, p in zip(names, before)}
        state = {}
        for p, st in optimizer.state.items():
            q = new_of[id(p)]
            state[q] = {
                k: (distribute_tensor(v.to(q.device), q.device_mesh,
                                      q.placements)
                    if isinstance(q, DTensor) and isinstance(v, torch.Tensor)
                    and v.shape == q.shape else v)
                for k, v in st.items()}
        for group in optimizer.param_groups:
            group["params"] = [new_of[id(p)] for p in group["params"]]
        optimizer.state.clear()
        optimizer.state.update(state)
    return model


def put_batch_2d(tree: Any, mesh: DeviceMesh) -> Any:
    """This rank's slice of a global batch: sharded over `data`,
    replicated over `model` (the ranks of one model group get the same
    rows)."""
    from qea_ocr_tpu_torch.parallel.mesh import put_batch
    return put_batch(tree, mesh, DATA_AXIS)


def is_sharded(model: nn.Module) -> bool:
    """Whether `model` is under `fully_shard`."""
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def full_tensor(x: Any) -> Any:
    """A `DTensor` gathered whole (a collective: every rank of its mesh
    must call); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _link(model: nn.Module, readers) -> None:
    """Point each reader's parameters at `model`'s current ones."""
    mine = dict(model.named_modules())
    for reader in readers:
        for name, sub in reader.named_modules():
            sub._parameters.update(mine[name]._parameters)


@contextlib.contextmanager
def unsharded(model: nn.Module, *readers: nn.Module):
    """Inside the block `model`'s parameters are whole plain tensors and
    each module in `readers` (a twin built over `model`, with the same
    module tree) holds them; after it the readers hold the shards again.
    Without `fully_shard` the readers hold what they held. No `DTensor`
    reaches a kernel's wrapper through a reader."""
    sharded = is_sharded(model)
    if sharded:
        model.unshard()
    try:
        _link(model, readers)
        yield
    finally:
        if sharded:
            model.reshard()
            _link(model, readers)


def state_dict_whole(model: nn.Module) -> dict:
    """`model.state_dict()` with every sharded entry gathered whole (a
    collective under `fully_shard`): the same layout-free checkpoint a
    single-process run writes."""
    return {k: full_tensor(v) for k, v in model.state_dict().items()}


def optimizer_state_whole(optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` with every sharded moment gathered whole."""
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: full_tensor(v) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd
