"""The area trainer's trajectory beside the JAX trainer's, at the area
quality run's configuration (`scripts/quality_run_area.py`: rangeCER at
a 25% budget, the history window of 3 with one jitter copy, identity
pretraining, the prep's cosine rate and its EMA), from one UNet
initialisation and one CRNN checkpoint.

As a script it runs one side at the quality run's full world (2,048 + 256
crops, 30 epochs, 6 pretraining epochs) on the CPU and writes the trainer's
`metrics.jsonl`, so that two runs can be read epoch by epoch:

    JAX_PLATFORMS=cpu python tests/test_torch_area_trajectory.py \
        {jax,port} OUT --crnn CKPT [--train 2048] [--val 256] \
        [--epochs 30] [--pretrain 6] [--init port|jax]

CKPT is a port checkpoint (a warmup's `crnn/model_*`), carried into the
JAX trainer by `qea_ocr_tpu/tools/import_torch.convert_crnn`. `--init port`
gives both sides the port's UNet initialisation (seed 4242), `--init jax`
the JAX trainer's own (flax's, from its seed). One side's epoch takes
minutes for the port and about ten for JAX on two cores. The sides
`jax-warmup` and `port-warmup` run the quality run's CRNN warmup instead
(4,096 + 256 crops, `--epochs` of them) and write its last state as a port
checkpoint, `OUT/crnn_last`, which either trainer then takes.

The test, marked `slow`, runs two epochs of both at a tiny world.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

CORRUPTION = {"noise_std": 0.14, "shading": 0.18, "salt_pepper": 0.007}


def quality_run_config(out, train_size, val_size, epochs, pretrain) -> dict:
    """`scripts/quality_run_area.py`'s `AreaTrainerConfig` at the
    yardstick's knobs (LR_SCHED_PREP=cosine PREP_EMA=0.995)."""
    return dict(
        epochs=epochs, ocr="Fake", dataset="synthetic",
        synthetic_train_size=train_size, synthetic_val_size=val_size,
        batch_size=64, corruption=CORRUPTION, minibatch_subset="rangeCER",
        minibatch_subset_prop=0.75, inner_limit=2, inner_limit_skip=True,
        window_size=3, weightgen_method="decaying", scalar=1.0,
        prep_pretrain_epochs=pretrain, prep_ema=0.995, lr_prep=2e-5,
        lr_scheduler_prep="cosine", lr_crnn=1e-4, exp_base_path=str(out))


def _jax_unet_variables(seed: int) -> dict:
    """The JAX area trainer's own UNet initialisation
    (`qea_ocr_tpu/train/area_trainer.py:251-258`) as numpy trees."""
    import jax
    import jax.numpy as jnp
    from qea_ocr_tpu.models import UNet as JUNet
    from qea_ocr_tpu.utils.platform import default_mxu_packed

    k1 = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    v = JUNet(init_features=32, mxu_packed=default_mxu_packed(),
              conv_impl="xla").init(k1, jnp.zeros((1, 1, 32, 128)),
                                    train=False)
    return jax.tree_util.tree_map(np.asarray, {
        "params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])})


def make_trainer(side: str, crnn_ckpt: str, cfg: dict, init: str = "port"):
    """One side's trainer, with the UNet initialisation `init` and the CRNN
    from the port checkpoint `crnn_ckpt`."""
    from qea_ocr_tpu_torch.models.unet import UNet

    unet = UNet(init_features=32, conv_impl="xla",
                generator=torch.Generator().manual_seed(4242))
    if side == "port":
        from qea_ocr_tpu_torch.train.area_trainer import (
            AreaTrainerConfig, TrainNNPrepArea)
        trainer = TrainNNPrepArea(AreaTrainerConfig(
            device="cpu", crnn_model=crnn_ckpt, **cfg))
        if init == "jax":
            from qea_ocr_tpu_torch.tools.convert import unet_state_dict
            trainer.prep_model.load_state_dict(unet_state_dict(
                _jax_unet_variables(trainer.cfg.random_seed)))
        else:
            trainer.prep_model.load_state_dict(unet.state_dict())
        return trainer

    import jax
    import jax.numpy as jnp
    from qea_ocr_tpu.tools.import_torch import convert_crnn, convert_unet
    from qea_ocr_tpu.train import area_trainer as jat

    trainer = jat.TrainNNPrepArea(jat.AreaTrainerConfig(**cfg))

    def cast(tree, like):
        return jax.tree_util.tree_map(lambda a, b: jnp.asarray(a, b.dtype),
                                      tree, like)
    sd = torch.load(crnn_ckpt, map_location="cpu", weights_only=True)
    cv = convert_crnn({k: v.numpy() for k, v in sd.items()
                       if not k.endswith("num_batches_tracked")})
    trainer.crnn_state = trainer.crnn_state.replace(
        params=cast(cv["params"], trainer.crnn_state.params),
        batch_stats=cast(cv["batch_stats"], trainer.crnn_state.batch_stats))
    if init == "port":
        uv = convert_unet({k: v.numpy() for k, v in unet.state_dict().items()
                           if not k.endswith("num_batches_tracked")})
        trainer.prep_state = trainer.prep_state.replace(
            params=cast(uv["params"], trainer.prep_state.params),
            batch_stats=cast(uv["batch_stats"],
                             trainer.prep_state.batch_stats))
    return trainer


def jax_numpy(state) -> dict:
    """A JAX `ModelState`'s `{'params', 'batch_stats'}` as numpy trees."""
    import jax

    return jax.tree_util.tree_map(np.asarray, {
        "params": dict(state.params), "batch_stats": dict(state.batch_stats)})


def warmup(side: str, out: str, epochs: int) -> str:
    """`scripts/quality_run_area.py`'s warmup (`:55-71`) on the JAX
    package or the port; -> the path of its last state as a port
    checkpoint."""
    from qea_ocr_tpu_torch.utils.io import save_checkpoint

    kw = dict(batch_size=64, lr=3e-4, epochs=epochs, dataset="synthetic",
              synthetic_train_size=4096, synthetic_val_size=256,
              corruption=CORRUPTION, ocr="Fake", std=3,
              crnn_model_path=os.path.join(out, "crnn/model"),
              log_dir=os.path.join(out, "crnn"))
    path = os.path.join(out, "crnn_last")
    if side == "port":
        from qea_ocr_tpu_torch.train.crnn_trainer import (
            CrnnTrainerConfig, TrainCRNN)
        warm = TrainCRNN(CrnnTrainerConfig(device="cpu", **kw))
        print(warm.train(), flush=True)
        save_checkpoint(path, warm.model)
        return path
    from qea_ocr_tpu.train.crnn_trainer import CrnnTrainerConfig, TrainCRNN
    from qea_ocr_tpu_torch.tools.convert import crnn_state_dict
    warm = TrainCRNN(CrnnTrainerConfig(**kw))
    print(warm.train(), flush=True)
    save_checkpoint(path, crnn_state_dict(jax_numpy(warm.state)))
    return path


def records(out) -> list:
    with open(os.path.join(str(out), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.slow
def test_two_epochs_at_the_quality_run_config_beside_the_jax_trainer(tmp_path):
    """Two epochs of both trainers at the quality run's configuration on 128 +
    64 crops, after a pretraining epoch, from one seeded CRNN: the ledgers
    are equal and each epoch's losses agree within 5%, as in
    `test_torch_area_trainer.py`'s single epoch (bfloat16 steps in two
    frameworks; a crop the fake OCR reads differently moves the CRNN
    loss)."""
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.utils.charmap import CharMap
    from qea_ocr_tpu_torch.utils.io import save_checkpoint

    crnn = str(tmp_path / "crnn_model")
    save_checkpoint(crnn, CRNN(CharMap.default().vocab_size,
                               generator=torch.Generator().manual_seed(0)))
    got = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        make_trainer(side, crnn, quality_run_config(out, 128, 64, 2, 1)).train()
        got[side] = records(out)
    assert len(got["port"]) == len(got["jax"]) == 2
    for jrec, trec in zip(got["jax"], got["port"]):
        assert list(trec) == list(jrec)
        for key in ("Black-Box Calls", "Total Black-Box Calls",
                    "Total CRNN Updates"):
            assert trec[key] == jrec[key], key
        for key in ("train_loss", "val_loss", "CRNN_loss"):
            assert trec[key] == pytest.approx(jrec[key], rel=5e-2), key


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("side", choices=("jax", "port", "jax-warmup",
                                    "port-warmup"))
    p.add_argument("out")
    p.add_argument("--crnn", help="the proxy, a port checkpoint")
    p.add_argument("--train", type=int, default=2048)
    p.add_argument("--val", type=int, default=256)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--pretrain", type=int, default=6)
    p.add_argument("--init", choices=("port", "jax"), default="port")
    a = p.parse_args(argv)
    # as many threads as the process may use (`taskset` sets it)
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    if a.side.startswith("jax"):
        import jax
        jax.config.update("jax_platforms", "cpu")
    if a.side.endswith("-warmup"):
        print(warmup(a.side.split("-")[0], a.out, a.epochs), flush=True)
        return
    if not a.crnn:
        p.error("the trainers need --crnn")
    cfg = quality_run_config(a.out, a.train, a.val, a.epochs, a.pretrain)
    print(make_trainer(a.side, a.crnn, cfg, a.init).train(), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
