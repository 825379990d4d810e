"""Faults planted in the program underneath a run, to show that the
comparison catches them (the CPU tests, and `control.py --fault` on the
card at a cell's own size):

  state unchanged  every optimizer update does nothing
  half batch       the CTC losses of the second half of each batch's rows
                   replaced by the mean of the first half's (half the
                   batch left out, the mean taken over the rest)
  token altered    each decoded row's first symbol changed where the
                   greedy decode produces it (an empty row gains one)
  answer altered   the serving forward's first document halved in grey
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state unchanged", "half batch", "token altered", "answer altered")


def _no_step(loss, *pairs):
    """An update that leaves the state unchanged."""


def _half_batch(samplewise):
    def broken(scores, labels, lengths, **kw):
        per = samplewise(scores, labels, lengths, **kw)
        half = max(1, per.shape[0] // 2)
        rest = per[:half].mean().expand(per.shape[0] - half)
        return torch.cat([per[:half], rest])
    return broken


def _altered_token(decode):
    def broken(scores, **kw):
        dec, n = decode(scores, **kw)
        dec = dec.clone()
        dec[:, 0] = torch.where(n > 0, dec[:, 0] % 94 + 1, 1)
        return dec, torch.clamp(n, min=1)
    return broken


def _answer_altered(forward):
    def broken(self, images):
        out = forward(self, images).clone()
        out[0] = out[0] // 2
        return out
    return broken


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted inside the block (None: as is)."""
    if fault is None:
        yield
        return
    from qea_ocr_tpu_torch.ops import ctc
    from qea_ocr_tpu_torch.serve import cleaner
    from qea_ocr_tpu_torch.tracking import loss
    from qea_ocr_tpu_torch.train import area_trainer, patch_steps
    if fault == "state unchanged":
        swaps = [(m, "optimizer_step", _no_step)
                 for m in (patch_steps, area_trainer)]
    elif fault == "half batch":
        swaps = [(m, "ctc_loss_samplewise",
                  _half_batch(m.ctc_loss_samplewise))
                 for m in (patch_steps, loss, ctc)]
    elif fault == "token altered":
        swaps = [(m, "greedy_decode", _altered_token(m.greedy_decode))
                 for m in (patch_steps, area_trainer)]
    elif fault == "answer altered":
        swaps = [(cleaner.DocumentCleaner, "_forward",
                  _answer_altered(cleaner.DocumentCleaner._forward))]
    else:
        raise ValueError(f"no fault {fault!r}: {FAULTS}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, new in swaps:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
