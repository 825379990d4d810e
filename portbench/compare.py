"""The numbers that decide `correct`, each judged against its limit.

Training (the first steps that set-up drives, followed by the reference
from the same weights and inputs):

  loss_gap        |program - reference| / |reference| of the first loss
                  the steps compute (phase A of the first step), before
                  any update: after Adam's first update, whose size is
                  the learning rate whatever the gradient, the two runs
                  part by a step on every element whose gradient is
                  within rounding of nought, and later losses read that
                  (`training_detail` keeps every step's)
  grad_gap        the first gradient, as the optimizer got it (from its
                  moments after one step), by the worst leaf: |norm of the
                  program's - norm of the reference's| over the larger of
                  the reference's norm of that leaf and of the median leaf
  change_gap      the same for each leaf's change over the steps followed,
                  by the worst leaf; leaves whose first reference gradient
                  is under a thousandth of the median leaf's (nought to
                  rounding, which Adam moves by round-off alone) are left
                  out
  selection_diff  strip slots the program selected where the reference did
                  not, or the reverse (exact)
  table_gap       largest distance between a CER table row the steps wrote
                  and the CER of the program's own decode against the
                  ground truth, or the row's old value where it was not
                  written (exact)
  decode_gap      the widest gap by which a decoded token's log-prob lies
                  below the reference's best at its step, on the least
                  such path to the program's decode (`reference/ops.py`)
  entropy_gap     mean over the strips written of |program - reference|
                  of the entropy written
  extract_gap     mean |program - reference| of the first step's
                  extracted strips (UNet eval forward and gather), in grey
                  levels (x 255)
  train_out_gap   the same for the first step's phase-B UNet output
                  (train-mode forward, before its update)

Serving (a sample of requests drawn from the seed after the window):

  pixel_mean_gap  mean over the sample's pixels of |program's uint8 -
                  reference's output x 255|, in grey levels
  pixel_max_gap   the largest such difference
  shape_diff      documents returned at another size than sent (exact)
"""

from __future__ import annotations

import statistics

import torch


def rel_gap(got: float, want: float) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)


def leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Each leaf's |‖got‖ - ‖want‖| / max(‖want‖, median leaf ‖want‖)."""
    names = [k for k in want if keep is None or k in keep]
    norms = {k: float(want[k].double().norm()) for k in names}
    med = statistics.median(norms.values())
    return [abs(float(got[k].double().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in names]


def moved_leaves(first_grad: dict) -> set:
    """Leaves whose first gradient is above a thousandth of the median
    leaf's norm."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def training(obs: dict, ref: dict, gt_rows: list, old_tables: list) -> list:
    """[(name, value)] for the program's (or the control's) observations
    `obs` against the reference's `ref`. Both hold `losses` (per step a
    tuple), `masks` (per step, bool numpy), `grad0` and `change` (dicts of
    leaves), `decoded` and `decoded_len` (per step), `cer_rows` and
    `ent_rows` (per step, the table rows of the step's strips after the
    steps followed); `ref` also `scores` (per step, (T, N, V)) and
    `entropy` (per step, (N,)). `gt_rows` per step: (labels list, valid
    bool list), `old_tables` per step: the (CER, entropy) rows before the
    step, which rows not written keep."""
    from portbench.reference.ops import cer, decode_gap
    loss_gap = rel_gap(obs["losses"][0][0], ref["losses"][0][0])
    sel = sum(int((a != b).sum()) for a, b in zip(obs["masks"],
                                                  ref["masks"]))
    grad_gap = max(leaf_gaps(obs["grad0"], ref["grad0"]))
    change_gap = max(leaf_gaps(obs["change"], ref["change"],
                               moved_leaves(ref["grad0"])))
    table, dgap, esum, en = 0.0, 0.0, 0.0, 0
    for k in range(len(obs["losses"])):
        labels, valid = gt_rows[k]
        dec = obs["decoded"][k].cpu()
        dlen = obs["decoded_len"][k].cpu()
        rows = obs["cer_rows"][k].cpu()
        ents = obs["ent_rows"][k].cpu()
        old_cer, old_ent = (x.cpu() for x in old_tables[k])
        for r in range(len(valid)):
            if valid[r]:
                want = cer(dec[r, :int(dlen[r])].tolist(), labels[r])
            else:
                want = float(old_cer[r])
                table = max(table, abs(float(ents[r]) - float(old_ent[r])))
            table = max(table, abs(float(rows[r]) - want))
        v = torch.tensor(valid)
        gaps = decode_gap(ref["scores"][k], dec, dlen)
        dgap = max(dgap, float(gaps[v].max()))
        d = (ents - ref["entropy"][k].cpu())[v].abs()
        esum += float(d.sum())
        en += d.numel()
    grey = lambda a, b: 255.0 * float((a.float().cpu() - b.float().cpu())
                                      .abs().mean())
    return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
            ("change_gap", change_gap), ("selection_diff", float(sel)),
            ("table_gap", table), ("decode_gap", dgap),
            ("entropy_gap", esum / max(en, 1)),
            ("extract_gap", grey(obs["extract"], ref["extract"])),
            ("train_out_gap", grey(obs["train_out"], ref["train_out"]))]


def training_detail(obs: dict, ref: dict) -> dict:
    """What the worst-leaf and every-step numbers are made of, for setting
    the limits: each step's loss gaps, each leaf's norms of first
    gradients and of changes beside the reference's, and for each moved
    leaf the share of its elements whose first gradient has another sign
    than the reference's (of all, and of those at least a tenth of the
    leaf's root mean square)."""
    def leaves(got, want):
        norms = {k: float(want[k].double().norm()) for k in want}
        med = statistics.median(norms.values())
        return med, {k: [float(got[k].double().norm()), n]
                     for k, n in norms.items()}
    gmed, grads = leaves(obs["grad0"], ref["grad0"])
    cmed, changes = leaves(obs["change"], ref["change"])
    moved = sorted(moved_leaves(ref["grad0"]))
    signs = {}
    for k in moved:
        g = ref["grad0"][k].double()
        flip = torch.sign(obs["grad0"][k].to(g.device).double()) \
            != torch.sign(g)
        rms = g.square().mean().sqrt()
        signs[k] = [float(flip.double().mean()),
                    float(flip[g.abs() >= 0.1 * rms].double().mean())]
    return {"losses": [[rel_gap(a, b) for a, b in zip(la, lb)]
                       for la, lb in zip(obs["losses"], ref["losses"])],
            "grad_median": gmed, "grads": grads, "change_median": cmed,
            "changes": changes, "moved": moved, "sign_flips": signs}


def judged(values: list, limits: dict) -> list:
    """[(name, value, limit)]; a number without a limit yet is judged
    against 0, so a cell is never correct by omission."""
    return [(n, v, float(limits.get(n, 0.0))) for n, v in values]
