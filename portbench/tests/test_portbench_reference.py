"""The plain reference against the port at tiny sizes on the CPU: each
model in float32 against the port's model in float32 (the same
arithmetic: agreement to rounding), each operation against the port's
plain version, and whole bfloat16 steps within the readings' limits."""

import numpy as np
import pytest
import torch

from portbench.reference import models as M
from portbench.reference import ops as O
from portbench.tests import _tiny
from portbench.weights import crnn_schema, make_state, unet_schema

DEV = torch.device("cpu")


def test_unet_matches_the_port_in_float32():
    from qea_ocr_tpu_torch.models.unet import UNet
    sd = make_state(unet_schema(4), 5, 1, DEV)
    net = UNet(init_features=4, compute_dtype=torch.float32)
    net.load_state_dict(sd, strict=True)
    x = torch.rand(2, 1, 32, 64)
    torch.testing.assert_close(net.eval()(x), M.unet(x, sd), rtol=1e-5,
                               atol=1e-5)
    ref_sd = {k: v.clone() for k, v in sd.items()}
    stats = []
    torch.testing.assert_close(net.train()(x), M.unet(x, ref_sd, True,
                                                      stats),
                               rtol=1e-4, atol=1e-5)
    M.fold_running(ref_sd, stats)
    for k in ("encoder1.enc1norm1.running_mean",
              "decoder1.dec1norm2.running_var"):
        torch.testing.assert_close(net.state_dict()[k], ref_sd[k],
                                   rtol=1e-5, atol=1e-6)


def test_crnn_matches_the_port_in_float32():
    from qea_ocr_tpu_torch.models.crnn import CRNN
    feats = [64, 128, 256, 256, 512, 512, 512]
    sd = make_state(crnn_schema(feats, 16, 2, 95), 5, 2, DEV)
    net = CRNN(95, lstm_hidden=16, compute_dtype=torch.float32)
    net.load_state_dict(sd, strict=True)
    x = torch.rand(3, 1, 32, 128)
    torch.testing.assert_close(net.eval()(x), M.crnn(x, sd, 16, 2),
                               rtol=1e-4, atol=1e-5)


def test_ops_match_the_port():
    from qea_ocr_tpu_torch.ops.ctc import ctc_loss_samplewise, greedy_decode
    from qea_ocr_tpu_torch.ops.cuda.gather_cuda import text_stack_plain
    from qea_ocr_tpu_torch.ops.edit_distance import cer_from_labels
    from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
    from qea_ocr_tpu_torch.selection.samplers import select_batch
    g = torch.Generator().manual_seed(3)
    docs = torch.rand(2, 1, 40, 150, generator=g)
    boxes = torch.tensor([[[0, 0, 20, 10], [140, 30, 150, 40]],
                          [[5, 5, 133, 37], [-3, -2, 10, 5]]],
                         dtype=torch.int32)
    torch.testing.assert_close(
        O.gather_strips(docs, boxes),
        text_stack_plain(docs, boxes).reshape(4, 1, 32, 128))
    scores = torch.log_softmax(torch.randn(31, 5, 95, generator=g), -1)
    labels = torch.randint(1, 95, (5, 100), generator=g, dtype=torch.int32)
    lengths = torch.tensor([3, 12, 7, 1, 9], dtype=torch.int32)
    torch.testing.assert_close(
        O.ctc_nll(scores, labels, lengths),
        ctc_loss_samplewise(scores, labels, lengths, pad_id=95),
        rtol=1e-5, atol=1e-4)
    dec, dlen = greedy_decode(scores, pad_id=95)
    mine = O.greedy_decode(scores)
    assert [dec[i, :dlen[i]].tolist() for i in range(5)] == mine
    gt = [labels[i, :lengths[i]].tolist() for i in range(5)]
    torch.testing.assert_close(
        torch.tensor([O.cer(mine[i], gt[i]) for i in range(5)]),
        cer_from_labels(dec[:, :100], dlen, labels, lengths))
    torch.testing.assert_close(O.entropy(scores),
                               mean_sequence_entropy(scores))
    assert float(O.decode_gap(scores, dec, dlen).max()) == 0.0
    est = torch.rand(3, 16, generator=g)
    valid = torch.rand(3, 16, generator=g) > 0.2
    noise = torch.rand(3, 16, generator=g)
    mask, _ = select_batch("rangeCER", None, est, valid, 0.75, noise=noise)
    assert np.array_equal(mask.numpy(), O.range_cer_select(
        est.numpy(), valid.numpy(), noise.numpy(), 0.75))


def test_adam_matches_the_port():
    from qea_ocr_tpu_torch.train.state import adam_l2
    g = torch.Generator().manual_seed(4)
    p = torch.randn(50, generator=g)
    mine = {"p": p.clone()}
    theirs = torch.nn.Parameter(p.clone())
    opt = adam_l2([theirs], 1e-3, 5e-4)
    ref = O.Adam(mine, 1e-3, 5e-4)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        theirs.grad = grad.clone()
        opt.step()
        ref.step({"p": grad})
    torch.testing.assert_close(theirs.detach(), mine["p"])


@pytest.mark.parametrize("name", ["patch-train-d8", "area-train-b64",
                                  "serve-patch-b32-cmajor"])
def test_bfloat16_steps_agree(name):
    out = _tiny.run(_tiny.cell(name))
    c = {k: v["value"] for k, v in out["checks"].items()}
    if "pixel_mean_gap" in c:
        assert c["shape_diff"] == 0 and c["pixel_mean_gap"] < 1.0
        return
    assert c["selection_diff"] == 0 and c["table_gap"] == 0
    assert c["loss_gap"] < 1e-2 and c["decode_gap"] < 0.05
    assert c["entropy_gap"] < 1e-3
