"""The benchmark's model-FLOP count against PyTorch's own count over the
plain reference, at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import models as M
from portbench.weights import crnn_schema, make_state, unet_schema

DEV = torch.device("cpu")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("f,H,W", [(4, 32, 64), (8, 48, 32)])
def test_unet_forward_and_training(f, H, W):
    sd = make_state(unet_schema(f), 1, 1, DEV)
    x = torch.rand(2, 1, H, W)
    layers = counts.unet_layers(f, H, W)
    assert _counted(lambda: M.unet(x, sd)) == counts.train_flops(
        layers, 2, False, False)
    for v in sd.values():
        if v.is_floating_point():
            v.requires_grad_(True)
    assert _counted(lambda: M.unet(x, sd, train=True).sum().backward()) \
        == counts.train_flops(layers, 2, True, False)


def test_crnn_forward_and_input_gradient():
    feats = [64, 128, 256, 256, 512, 512, 512]
    sd = make_state(crnn_schema(feats, 16, 2, 95), 1, 2, DEV)
    x = torch.rand(3, 1, 32, 128)
    layers = counts.crnn_layers(feats, 16, 2, 95)
    assert _counted(lambda: M.crnn(x, sd, 16, 2)) == counts.train_flops(
        layers, 3, False, False)
    xi = x.clone().requires_grad_(True)
    got = _counted(lambda: M.crnn(xi, sd, 16, 2).sum().backward(
        inputs=[xi]))
    # autograd skips the gradient of each LSTM's zero initial state (one
    # recurrent matmul a direction and layer), which the count includes
    skipped = 2 * 2 * 2 * 3 * 16 * 4 * 16
    assert got + skipped == counts.train_flops(layers, 3, False, True)


def test_full_size_step_counts():
    cfg = dict(unet_features=32, conv_features=[64, 128, 256, 256, 512, 512,
                                                512],
               lstm_hidden=256, lstm_layers=2, vocab_size=95,
               doc_size=[400, 512], strip_size=[32, 128], strip_slots=16)
    per_doc = counts.patch_step_flops(cfg, 96, 1) / 96
    assert 5.2e11 < per_doc < 5.4e11
    assert 7.4e10 < counts.unet_forward_flops(cfg, 1) < 7.6e10
