"""Shared helper of the port's parity tests (`tests/test_torch_*.py`)."""

import jax
import numpy as np


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
