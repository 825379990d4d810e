"""Shared helper of the port's parity tests (`tests/test_torch_*.py`)."""

import jax
import numpy as np
import torch

# The parity tests run tiny shapes, which gain nothing from intra-op threads,
# beside JAX files that need the cores.
torch.set_num_threads(1)


def perturbed_variables(variables, seed):
    """flax `{'params', 'batch_stats'}` as writable numpy arrays, with every
    BatchNorm's scale/bias and running mean/var redrawn away from 1/0 and
    0/1, so a mix-up of the four shows in a parity test."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(lambda a: np.array(a), variables)

    def walk(params, stats):
        for k in params:
            if k.startswith("BatchNorm"):
                c = params[k]["scale"].shape
                params[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                params[k]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[k]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(params[k], dict) and k in stats:
                walk(params[k], stats[k])
    walk(v["params"], v["batch_stats"])
    return v


def flax_variables_like(flax_model, port_model, example_shape, seed):
    """Random flax variables for `flax_model`, made without a flax init
    (slow on the CPU): the seeded `port_model`'s weights through the JAX
    package's importer (`tools/import_torch.py`), with perturbed batch
    norms. The tree is checked against the abstract flax init, leaf for
    leaf, so the importer cannot hide a layout the flax model would not
    take; parity tests then carry the variables back with the exporter."""
    import jax.numpy as jnp
    from qea_ocr_tpu.tools.import_torch import convert_crnn, convert_unet

    sd = {k: t.numpy() for k, t in port_model.state_dict().items()}
    convert = convert_unet if "conv.weight" in sd else convert_crnn
    v = perturbed_variables(convert(sd), seed)
    want = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros(example_shape), train=False),
        jax.random.PRNGKey(0))
    got = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), v)
    assert got == want, "imported variables do not match the flax model"
    return v


def jax_variables(state):
    """A JAX `ModelState`'s `{'params', 'batch_stats'}` as numpy trees."""
    return {"params": jax.tree_util.tree_map(np.asarray, dict(state.params)),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  dict(state.batch_stats))}


def parser_flags(parser):
    """An argparse parser's options as comparable records, by destination,
    in the order they were added (help texts left out)."""
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        out[a.dest] = dict(
            options=tuple(a.option_strings), default=a.default, type=a.type,
            nargs=a.nargs, kind=type(a).__name__,
            choices=None if a.choices is None else tuple(a.choices))
    return out


class RecordingTrial:
    """An optuna-like trial for the trainers' `optuna_trial`: it records
    each `report(value, epoch)` and asks to prune once epoch `prune_after`
    has reported."""

    def __init__(self, prune_after: int = 0):
        self.reports = []
        self.prune_after = prune_after

    def report(self, value, step):
        self.reports.append((value, step))

    def should_prune(self):
        return bool(self.reports) and self.reports[-1][1] >= self.prune_after


def trial_pruned_type():
    """What `_maybe_optuna` raises for a pruned trial: `optuna.TrialPruned`
    where `optuna` imports (a stub of it too), else `RuntimeError`."""
    try:
        import optuna
    except ImportError:
        return RuntimeError
    return optuna.TrialPruned
