"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, one fault planted in the program at a time."""

import pytest

from portbench import faults
from portbench.tests import _tiny


# each fault with the number that is to catch it
CASES = [("patch-train-d8", "state unchanged", "change_gap"),
         ("patch-train-d8", "half batch", "loss_gap"),
         ("patch-train-d8", "token altered", "decode_gap"),
         ("area-train-b64", "state unchanged", "change_gap"),
         ("area-train-b64", "half batch", "loss_gap"),
         ("area-train-b64", "token altered", "decode_gap"),
         ("serve-patch-b32-cmajor", "answer altered", "pixel_max_gap")]


@pytest.fixture(scope="module")
def sound():
    return {}


@pytest.mark.parametrize("name,fault,number", CASES)
def test_fault_is_not_correct(sound, name, fault, number):
    if name not in sound:
        sound[name] = _tiny.run(_tiny.cell(name))["checks"]
    assert sound[name][number]["value"] <= sound[name][number]["limit"]
    with faults.planted(fault):
        out = _tiny.run(_tiny.cell(name))
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("name", ["patch-train-d8", "area-train-b64"])
def test_one_leaf_left_unmoved_is_not_correct(name):
    """The change is judged by the worst leaf: an update that skips one
    layer fails it, where the median leaf would not."""
    import torch

    from portbench import compare, harness
    c = _tiny.cell(name)
    run = harness.Run(c, 2 ** 31 + 27, torch.device("cpu"))
    driver = c.driver_class()(run)
    driver.setup()
    driver.release()
    change = driver.obs["change"]
    leaf = max(change, key=lambda k: float(change[k].norm()))
    change[leaf] = torch.zeros_like(change[leaf])
    judged = dict((n, (v, lim)) for n, v, lim in compare.judged(
        driver.readings()[0], c.limits))
    v, lim = judged["change_gap"]
    assert v > lim, judged
