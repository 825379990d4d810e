"""Import reference-trained PyTorch checkpoints into the port (counterpart of
`qea_ocr_tpu/tools/import_torch.py`).

The reference saves whole-module pickles, `torch.save(self.prep_model, ...)`
(reference `train_nn_patch.py:441`) of `models/model_unet.py:UNet` and
`models/model_crnn.py:CRNN`, so a user migrating from the reference arrives
with trained `Prep_model_{epoch}_{acc}` / `CRNN_model_{epoch}` files. This
tool loads those, without the reference package being importable (a stub
unpickler rebuilds the module tree from the pickle's
`_parameters` / `_buffers` / `_modules`), or plain state_dict pickles, and
writes the port's checkpoint: the model's bare state_dict, which
`--prep_model` / `--crnn_model` of the trainers and `--prep_path` of
`clean_docs` / `eval_prep` load.

The reference key schema is the port's own, so no weight changes layout.
What changes:

* `nn.DataParallel`'s `module.` segments are dropped (`convo.module.conv1`
  -> `convo.conv1`, reference `model_crnn.py:11-12`);
* each LSTM direction's two biases are folded into `bias_hh`, with
  `bias_ih` zero: the port trains one bias (`models/crnn.py`), and a
  reference checkpoint then reaches the same state_dict through this tool
  as through the JAX package's importer followed by `tools/convert.py`;
* `num_batches_tracked` is dropped, as the JAX loader drops it, and the
  port's model supplies its own (0); floating tensors become float32.

A checkpoint of another capacity (`unet_features`, `lstm_hidden`) fails
with a `ValueError` that names the mismatch. A pickle runs code when it is
loaded: import only checkpoints from a source you trust.

Run: python -m qea_ocr_tpu_torch.tools.import_torch --kind prep \\
       --torch_path Prep_model_7_81.54 --out prep.pt [--unet_features 32]
"""

from __future__ import annotations

import argparse
import io
import pickle
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.io import save_checkpoint


# --------------------------------------------------------------- torch loading
class _Stub:
    """Placeholder for classes whose module is not importable (the reference
    repo's model classes inside whole-module pickles)."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - exotic __reduce__ protocols
            self.__dict__["_pickle_state"] = state


def _stub_unpickler_module():
    """A pickle-module shim whose Unpickler falls back to `_Stub` subclasses
    for unimportable classes, for `torch.load(pickle_module=...)`."""
    import types

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Stub,), {"__module__": module})

    shim = types.ModuleType("qea_stub_pickle")
    shim.Unpickler = StubUnpickler
    shim.load = lambda f, **kw: StubUnpickler(f, **kw).load()
    shim.loads = lambda b, **kw: StubUnpickler(io.BytesIO(b), **kw).load()
    return shim


def _flatten_module(obj, prefix: str, out: "OrderedDict[str, np.ndarray]"):
    """Recursively flatten a (possibly stubbed) nn.Module object graph into a
    state_dict-ordered {dotted_name: ndarray}."""
    d = getattr(obj, "__dict__", {})
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = np.asarray(p.detach().cpu().numpy()
                                            if hasattr(p, "detach") else p)
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = np.asarray(b.detach().cpu().numpy()
                                            if hasattr(b, "detach") else b)
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _flatten_module(m, prefix + name + ".", out)


def _normalize_key(key: str) -> str:
    """Drop `nn.DataParallel` wrapper segments (`convo.module.conv1` ->
    `convo.conv1`; reference `model_crnn.py:11-12`)."""
    parts = [p for p in key.split(".") if p != "module"]
    return ".".join(parts)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a reference checkpoint — whole-module pickle OR state_dict — into
    a flat {name: float32 ndarray} with DataParallel prefixes stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_stub_unpickler_module())
    flat: "OrderedDict[str, np.ndarray]" = OrderedDict()
    if isinstance(obj, (dict, OrderedDict)):
        for k, v in obj.items():
            if hasattr(v, "detach"):
                flat[k] = np.asarray(v.detach().cpu().numpy())
            else:
                flat[k] = np.asarray(v)
    else:
        _flatten_module(obj, "", flat)
    out = OrderedDict()
    for k, v in flat.items():
        if k.endswith("num_batches_tracked"):
            continue
        out[_normalize_key(k)] = (v.astype(np.float32)
                                  if v.dtype.kind == "f" else v)
    if not out:
        raise ValueError(f"no tensors found in {path!r}")
    return out


# ------------------------------------------------------------------ the port
def _fold_lstm_biases(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`bias_hh` <- `bias_ih + bias_hh` and `bias_ih` <- 0 for every LSTM
    direction (the port's one trained bias; `tools/convert.py` writes the
    same from the JAX cell's single bias)."""
    sd = dict(sd)
    for k in [k for k in sd if k.startswith("lstm.bias_ih_")]:
        hh = "lstm.bias_hh_" + k[len("lstm.bias_ih_"):]
        sd[hh] = sd[k] + sd[hh]
        sd[k] = np.zeros_like(sd[k])
    return sd


def _into(model: torch.nn.Module, sd: Dict[str, np.ndarray], kind: str
          ) -> torch.nn.Module:
    """Load `sd` into `model` (`num_batches_tracked` kept from the model),
    or raise a ValueError naming every missing, unexpected and misshapen
    entry."""
    template = model.state_dict()
    want = {k for k in template if not k.endswith("num_batches_tracked")}
    missing = sorted(want - set(sd))
    unexpected = sorted(set(sd) - want)
    shapes = sorted(f"{k}: checkpoint {tuple(sd[k].shape)}, model "
                    f"{tuple(template[k].shape)}"
                    for k in want & set(sd)
                    if tuple(sd[k].shape) != tuple(template[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(
            f"{kind}: the checkpoint does not match the model's state_dict "
            f"(wrong capacity?)\n  missing: {missing}\n  unexpected: "
            f"{unexpected}\n  shapes: {shapes}")
    model.load_state_dict(
        {**template, **{k: torch.from_numpy(np.array(sd[k])) for k in want}},
        strict=True)
    return model


def import_prep(torch_path: str, out_path: str, unet_features: int = 32
                ) -> "OrderedDict[str, torch.Tensor]":
    """Reference `Prep_model_*` pickle or state_dict -> the port's UNet
    checkpoint at `out_path`. Returns its state_dict."""
    model = _into(UNet(init_features=unet_features, conv_impl="xla"),
                  load_torch_state_dict(torch_path), "prep/UNet")
    save_checkpoint(out_path, model)
    return model.state_dict()


def import_crnn(torch_path: str, out_path: str, vocab_size: int | None = None,
                lstm_hidden: int = 256) -> "OrderedDict[str, torch.Tensor]":
    """Reference `CRNN_model_*` pickle or state_dict -> the port's CRNN
    checkpoint at `out_path`. Returns its state_dict."""
    sd = _fold_lstm_biases(load_torch_state_dict(torch_path))
    if vocab_size is None:
        vocab_size = int(sd["linear.weight"].shape[0])
    if vocab_size != CharMap.default().vocab_size:
        print(f"[import_torch] note: checkpoint vocab {vocab_size} != "
              f"default charset vocab {CharMap.default().vocab_size}")
    model = _into(CRNN(vocab_size, lstm_hidden=lstm_hidden), sd,
                  "proxy/CRNN")
    save_checkpoint(out_path, model)
    return model.state_dict()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert reference PyTorch checkpoints (whole-module "
                    "pickles or state_dicts) to the port's checkpoints.")
    p.add_argument("--kind", choices=("prep", "crnn"), required=True)
    p.add_argument("--torch_path", required=True,
                   help="reference Prep_model_*/CRNN_model_* pickle")
    p.add_argument("--out", required=True, help="checkpoint file to write")
    p.add_argument("--unet_features", type=int, default=32)
    p.add_argument("--lstm_hidden", type=int, default=256)
    args = p.parse_args(argv)
    if args.kind == "prep":
        import_prep(args.torch_path, args.out,
                    unet_features=args.unet_features)
    else:
        import_crnn(args.torch_path, args.out, lstm_hidden=args.lstm_hidden)
    print(f"[import_torch] wrote {args.out}")


if __name__ == "__main__":
    main()
