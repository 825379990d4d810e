"""What the drivers share on the program's side: the models built from the
benchmark's weights, the optimizers, and the snapshots of the first steps
that the reference follows."""

from __future__ import annotations

import torch

from portbench.weights import crnn_schema, make_state, unet_schema


def compute_dtype(cfg: dict) -> torch.dtype:
    """The convs' and matmuls' type that the configuration states."""
    return getattr(torch, cfg["compute_dtype"])


def check_policy(model, cfg: dict) -> None:
    """Refuse a model that runs another policy than the configuration
    states: its compute type, and its parameters' type."""
    want = (compute_dtype(cfg), getattr(torch, cfg["param_dtype"]))
    got = {(model.compute_dtype, p.dtype) for p in model.parameters()}
    if got != {want}:
        raise ValueError(f"{type(model).__name__} runs {sorted(map(str, got))}"
                         f"; the configuration states {want}")


def build_models(cfg: dict, seed: int, device):
    """The program's UNet and CRNN, on `device`, holding the benchmark's
    weights for `seed` (the reference makes the same), in the
    configuration's compute policy."""
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
    gen = torch.Generator(device=device).manual_seed(0)
    dt = compute_dtype(cfg)
    with torch.device(device):
        unet = UNet(init_features=cfg["unet_features"], compute_dtype=dt,
                    generator=gen)
        unet.load_state_dict(make_state(unet_schema(cfg["unet_features"]),
                                        seed, 1, device), strict=True)
        check_policy(unet, cfg)
        model = CRNN(cfg["vocab_size"], lstm_hidden=cfg["lstm_hidden"],
                     lstm_layers=cfg["lstm_layers"], compute_dtype=dt,
                     generator=gen)
        model.load_state_dict(make_state(
            crnn_schema(cfg["conv_features"], cfg["lstm_hidden"],
                        cfg["lstm_layers"], cfg["vocab_size"]),
            seed, 2, device), strict=True)
        check_policy(model, cfg)
    return unet, model


def first_gradient(model, optimizer, wd: float, p0: dict) -> dict:
    """Each leaf's first gradient as the optimizer got it, from Adam's
    first moment after one step: m = 0.1 (g + wd p0)."""
    out = {}
    for name, p in model.named_parameters():
        # no moment: the optimizer never stepped this leaf
        m = optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
        out[name] = (m / 0.1 - wd * p0[name]).detach().cpu()
    return out


def parameters(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


class exact_float32:
    """float32 matmuls and convs without TF32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
