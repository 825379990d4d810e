"""The control: the plain reference at the precision below the stated one
(float8 operands for the bfloat16 policy), put in the program's place,
comes out not correct; the program at the same size reads lower on every
number the control fails."""

import pytest
import torch

from portbench import compare, harness, program
from portbench.reference import precision
from portbench.reference.precision import fp8_e4m3
from portbench.tests import _tiny


@pytest.mark.parametrize("name", ["patch-train-d8", "area-train-b64",
                                  "serve-patch-b32-cmajor"])
def test_control_is_not_correct(name):
    c = _tiny.cell(name)
    run = harness.Run(c, 2 ** 31 + 21, torch.device("cpu"))
    driver = c.driver_class()(run)
    driver.setup()
    if c.traffic["driver"] == "serve":
        for i in range(c.traffic["sample_requests"]):
            driver.step(i)
    driver.release()
    prog, ctl = driver.readings(precision.control(c.config))
    judged = compare.judged(ctl, c.limits)
    failed = [n for n, v, lim in judged if v > lim]
    assert failed, judged
    mine = dict(prog)
    assert any(mine[n] < v for n, v, _ in judged if n in failed)


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 101)
    r = fp8_e4m3(x)
    assert float((r - x).abs().max()) > 1e-3
    assert float(((r - x).abs() / x.abs().clamp(min=0.1)).max()) < 0.07
    assert torch.equal(fp8_e4m3(r), r)


def test_the_stated_policy_is_run_and_sets_the_control():
    c = _tiny.cell("patch-train-d8")
    assert precision.control(c.config) is fp8_e4m3
    unet, crnn = program.build_models(c.config, 1, torch.device("cpu"))
    assert unet.compute_dtype == crnn.compute_dtype == torch.bfloat16
    cfg = dict(c.config, compute_dtype="float32")
    unet, _ = program.build_models(cfg, 1, torch.device("cpu"))
    assert unet.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="states"):
        program.check_policy(unet, c.config)
    with pytest.raises(ValueError, match="states"):
        program.check_policy(unet, dict(cfg, param_dtype="bfloat16"))
    with pytest.raises(ValueError, match="no control"):
        precision.control(dict(cfg, compute_dtype="float64"))


def test_serving_refuses_a_policy_the_cleaner_does_not_run():
    c = _tiny.cell("serve-patch-b32-cmajor")
    c.config["compute_dtype"] = "float32"
    run = harness.Run(c, 2 ** 31 + 23, torch.device("cpu"))
    with pytest.raises(ValueError, match="states"):
        c.driver_class()(run).setup()
