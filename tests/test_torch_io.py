"""The port's experiment I/O and metrics helpers (`utils/io.py`,
`utils/metrics.py`): directories and JSON equal to the JAX package's, a PNG
writer that needs no imaging library, checkpoints as reference-schema
state_dicts with the optimizer's state beside them."""

import json
import os

import numpy as np
import pytest
import torch

from qea_ocr_tpu.utils import io as jio
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.train.state import adam_l2
from qea_ocr_tpu_torch.utils import io as tio
from qea_ocr_tpu_torch.utils.metrics import (
    MetricsLogger, StepTimer, maybe_profile)

import _torch_parity  # noqa: F401  (one torch thread)


def test_exp_dirs_and_json_match_the_jax_package(tmp_path):
    t = tio.ExpDirs(str(tmp_path / "t")).create()
    j = jio.ExpDirs(str(tmp_path / "j")).create()
    assert sorted(os.listdir(t.base)) == sorted(os.listdir(j.base))
    for name in ("ckpts", "cers", "tracked_labels", "selected_samples",
                 "img_out"):
        assert os.path.relpath(getattr(t, name), t.base) \
            == os.path.relpath(getattr(j, name), j.base)
    obj = {"a": [1, 2.5, True], "b": {"c": "d"}}
    tio.save_json(obj, str(tmp_path / "t.json"))
    jio.save_json(obj, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tio.load_json(str(tmp_path / "j.json")) == obj


@pytest.mark.parametrize("shape", [(37, 53), (1, 16, 8)])
def test_png_writer_equals_the_jax_package_pixel_for_pixel(tmp_path, shape):
    from PIL import Image

    img = np.random.default_rng(0).uniform(-0.2, 1.2, shape).astype(np.float32)
    tio.save_image_png(img, str(tmp_path / "t.png"))
    jio.save_image_png(img, str(tmp_path / "j.png"))
    got = np.asarray(Image.open(tmp_path / "t.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    assert got.dtype == np.uint8 and got.shape == shape[-2:]
    np.testing.assert_array_equal(got, want)
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    tio.save_image_png(u8, str(tmp_path / "u.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "u.png")),
                                  want)


def test_image_grid(tmp_path):
    from PIL import Image

    imgs = np.random.default_rng(1).random((5, 1, 6, 7)).astype(np.float32)
    tio.save_image_grid(imgs, str(tmp_path / "t.png"), nrow=3)
    jio.save_image_grid(imgs, str(tmp_path / "j.png"), nrow=3)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def _trained_crnn(seed):
    model = CRNN(20, lstm_hidden=8,
                 generator=torch.Generator().manual_seed(seed))
    opt = adam_l2(model.parameters(), 1e-3, 5e-4)
    x = torch.rand((2, 1, 32, 128), generator=torch.Generator().manual_seed(1))
    model(x).square().mean().backward()
    opt.step()
    return model, opt


def test_checkpoint_round_trip_with_and_without_the_optimizer(tmp_path):
    model, opt = _trained_crnn(2)
    path = str(tmp_path / "CRNN_model_0")
    tio.save_checkpoint(path, model, opt)
    # the model file is a bare state_dict of plain tensors
    sd = torch.load(path, weights_only=True)
    assert list(sd) == list(model.state_dict())

    fresh, fresh_opt = _trained_crnn(3)
    moments = fresh_opt.state_dict()["state"][0]["exp_avg"].clone()
    tio.load_checkpoint(path, fresh)                 # warm start
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert torch.equal(fresh_opt.state_dict()["state"][0]["exp_avg"], moments)
    tio.load_checkpoint(path, fresh, fresh_opt)      # full-state resume
    want = opt.state_dict()["state"]
    for i, s in fresh_opt.state_dict()["state"].items():
        assert torch.equal(s["exp_avg_sq"], want[i]["exp_avg_sq"])

    tio.save_checkpoint(str(tmp_path / "model_only"), model)
    assert not os.path.exists(str(tmp_path / "model_only") + tio.OPTIM_SUFFIX)
    with pytest.raises(FileNotFoundError):
        tio.load_checkpoint(str(tmp_path / "model_only"), fresh, fresh_opt)
    other = CRNN(20, lstm_hidden=4)
    with pytest.raises(RuntimeError):
        tio.load_checkpoint(path, other)             # strict


def test_metrics_logger_and_timer(tmp_path):
    log = MetricsLogger(str(tmp_path / "run"))
    log.log({"a": np.float32(1.5), "b": torch.tensor(2), "c": "x", "d": 3})
    log.log({"a": 2.0})
    log.update_summary({"best": np.int64(4)})
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert recs == [{"a": 1.5, "b": 2, "c": "x", "d": 3}, {"a": 2.0}]
    assert log.summary == {"best": 4}
    MetricsLogger(None).log({"a": 1})                # no directory: no file

    timer = StepTimer()
    for _ in range(2):
        with timer.time("step"):
            pass
    s = timer.summary()
    assert set(s) == {"time/step_mean_s", "time/step_total_s"}
    assert timer.counts["step"] == 2
    assert s["time/step_total_s"] == pytest.approx(2 * s["time/step_mean_s"])


def test_maybe_profile(tmp_path):
    with maybe_profile(None):
        pass
    with maybe_profile(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
