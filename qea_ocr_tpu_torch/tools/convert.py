"""Carry JAX weights into the port: flax `{'params', 'batch_stats'}` trees
(numpy leaves) -> reference-schema state_dicts.

The mapping is the port's own copy of the pure-numpy part of
`qea_ocr_tpu/tools/export_torch.py` (`tests/test_torch_host_copies.py`
holds the two equal):

* flax `kernel` (kH, kW, I, O) -> `Conv2d.weight` (O, I, kH, kW)
* flax `ConvTranspose` kernel -> `ConvTranspose2d.weight` (I, O, kH, kW),
  spatially flipped back
* params scale/bias + batch_stats mean/var -> `BatchNorm2d`
  weight/bias/running_mean/running_var (+ `num_batches_tracked = 0`)
* per-gate `OptimizedLSTMCell` Dense kernels -> fused
  `weight_ih_l{k}[_reverse]` (4H rows, i,f,g,o); the single flax
  hidden-side bias becomes `bias_hh` with `bias_ih` zero
* `Dense.kernel` (in, out) -> `Linear.weight` (out, in)
* HistoryAttention: the embedding table (a flax `constants` entry unless
  trained), the positional encodings and its two Dense layers

Applied to a JAX state after a training step, the same mapping gives the
state_dict the port's models should hold after the same step.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# (reference block name, parameter-name prefix inside it, flax block name)
_UNET_BLOCKS = [
    ("encoder1", "enc1", "enc1"),
    ("encoder2", "enc2", "enc2"),
    ("encoder3", "enc3", "enc3"),
    ("encoder4", "enc4", "enc4"),
    ("bottleneck", "bottleneck", "bottleneck"),
    ("decoder4", "dec4", "dec4"),
    ("decoder3", "dec3", "dec3"),
    ("decoder2", "dec2", "dec2"),
    ("decoder1", "dec1", "dec1"),
]


def _conv_weight(k: np.ndarray) -> np.ndarray:
    """flax HWIO kernel -> Conv2d (O, I, kH, kW)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _convT_weight(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose kernel -> ConvTranspose2d (I, O, kH, kW),
    un-flipping the spatial axes."""
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))


def _bn_out(sd: "OrderedDict[str, np.ndarray]", prefix: str,
            params: dict, stats: dict) -> None:
    sd[prefix + ".weight"] = np.asarray(params["scale"])
    sd[prefix + ".bias"] = np.asarray(params["bias"])
    sd[prefix + ".running_mean"] = np.asarray(stats["mean"])
    sd[prefix + ".running_var"] = np.asarray(stats["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _lstm_out(sd: "OrderedDict[str, np.ndarray]", cell_fwd: dict,
              cell_bwd: dict, layer: int) -> None:
    for cell, sfx in ((cell_fwd, f"l{layer}"), (cell_bwd, f"l{layer}_reverse")):
        wih = np.concatenate(
            [np.asarray(cell["i" + g]["kernel"]).T for g in "ifgo"], axis=0)
        whh = np.concatenate(
            [np.asarray(cell["h" + g]["kernel"]).T for g in "ifgo"], axis=0)
        bias = np.concatenate(
            [np.asarray(cell["h" + g]["bias"]) for g in "ifgo"], axis=0)
        sd[f"lstm.weight_ih_{sfx}"] = np.ascontiguousarray(wih)
        sd[f"lstm.weight_hh_{sfx}"] = np.ascontiguousarray(whh)
        sd[f"lstm.bias_ih_{sfx}"] = np.zeros_like(bias)
        sd[f"lstm.bias_hh_{sfx}"] = bias


def state_dict_from_unet(variables: Dict[str, dict]
                         ) -> "OrderedDict[str, np.ndarray]":
    """flax UNet `{'params', 'batch_stats'}` -> reference-schema state_dict
    with numpy values."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for ref, inner, flax_name in _UNET_BLOCKS:
        blk_p, blk_s = params[flax_name], stats[flax_name]
        for j in (1, 2):
            sd[f"{ref}.{inner}conv{j}.weight"] = _conv_weight(
                np.asarray(blk_p[f"Conv_{j - 1}"]["kernel"]))
            _bn_out(sd, f"{ref}.{inner}norm{j}",
                    blk_p[f"BatchNorm_{j - 1}"], blk_s[f"BatchNorm_{j - 1}"])
    for lvl in (4, 3, 2, 1):
        up = params[f"upconv{lvl}"]
        sd[f"upconv{lvl}.weight"] = _convT_weight(np.asarray(up["kernel"]))
        sd[f"upconv{lvl}.bias"] = np.asarray(up["bias"])
    sd["conv.weight"] = _conv_weight(np.asarray(params["Conv_0"]["kernel"]))
    sd["conv.bias"] = np.asarray(params["Conv_0"]["bias"])
    return sd


def state_dict_from_crnn(variables: Dict[str, dict]
                         ) -> "OrderedDict[str, np.ndarray]":
    """flax CRNN `{'params', 'batch_stats'}` -> reference-schema state_dict
    with numpy values."""
    params = variables["params"]
    conv_p = params["ConvStack_0"]
    conv_s = variables["batch_stats"]["ConvStack_0"]
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for j in range(1, 8):
        c = conv_p[f"Conv_{j - 1}"]
        sd[f"convo.conv{j}.weight"] = _conv_weight(np.asarray(c["kernel"]))
        sd[f"convo.conv{j}.bias"] = np.asarray(c["bias"])
    for j in (1, 2):
        _bn_out(sd, f"convo.batchnorm{j}",
                conv_p[f"BatchNorm_{j - 1}"], conv_s[f"BatchNorm_{j - 1}"])
    n_cells = sum(1 for k in params if k.startswith("OptimizedLSTMCell_"))
    for layer in range(n_cells // 2):
        _lstm_out(sd, params[f"OptimizedLSTMCell_{2 * layer}"],
                  params[f"OptimizedLSTMCell_{2 * layer + 1}"], layer)
    sd["linear.weight"] = np.ascontiguousarray(
        np.asarray(params["Dense_0"]["kernel"]).T)
    sd["linear.bias"] = np.asarray(params["Dense_0"]["bias"])
    return sd


def _to_torch(sd) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict((k, torch.from_numpy(np.array(v))) for k, v in sd.items())


def unet_state_dict(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX UNet `{'params', 'batch_stats'}` (numpy leaves) -> state_dict of
    `qea_ocr_tpu_torch.models.unet.UNet`."""
    return _to_torch(state_dict_from_unet(variables))


def crnn_state_dict(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX CRNN `{'params', 'batch_stats'}` (numpy leaves) -> state_dict of
    `qea_ocr_tpu_torch.models.crnn.CRNN`."""
    return _to_torch(state_dict_from_crnn(variables))


def attention_state_dict(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX HistoryAttention variables (`params`, and `constants` holding the
    frozen embedding unless it is trained) -> state_dict of
    `qea_ocr_tpu_torch.models.attention.HistoryAttention`."""
    params = variables["params"]
    emb = params["embedding"] if "embedding" in params \
        else variables["constants"]["embedding"]
    sd = OrderedDict(
        embedding=np.asarray(emb),
        positional_encodings=np.asarray(params["positional_encodings"]))
    for name in ("Wq", "loss_coef_layer"):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(params[name]["bias"])
    return _to_torch(sd)


def load_state_dict_file(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A state_dict pickle (e.g. written by the JAX package's
    `tools/export_torch.py`), loaded as plain tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
