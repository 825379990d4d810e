"""The plain reference of one patch step over the global batch of a
`torch.distributed` group: each rank follows its own documents
(`reference/train.py`'s step, written out below with the exchanges it
needs) and plain `torch.distributed` sums make the step the global one:

  phase A   each CTC mean divides the rank's sum by the group's count of
            rows; the gradients are summed over the ranks before the update
  phase B   the UNet's train-mode batch norm normalises with the group's
            mean and biased variance (sums through autograd, so the
            gradient runs through them, and the running statistics move
            by them); the loss divides by the group's count of documents;
            the gradients are summed
  losses    reported as the sum of the ranks' shares, the global loss

Nothing here imports the program or its `parallel/` module. The CER and
entropy rows each rank returns are its own strips'."""

from __future__ import annotations

from unittest import mock

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce

from portbench.reference import models as M
from portbench.reference import ops as O
from portbench.reference import train

LOCAL_BATCH_NORM = M.batch_norm


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the group's ranks, without a gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _SummedAdam:
    """Adam whose step first sums each gradient over the group, in place
    (so the caller's note of the first gradient is the global one)."""

    def __init__(self, opt, group):
        self.opt, self.group = opt, group

    def step(self, grads: dict) -> None:
        for g in grads.values():
            dist.all_reduce(g, group=self.group)
        self.opt.step(grads)


class Follower(train.Follower):
    """`train.Follower` stepped over the group's global batch."""

    def __init__(self, cfg, t, seed, device, group, q=None):
        super().__init__(cfg, t, seed, device, q)
        self.group = group
        self.opt_u = _SummedAdam(self.opt_u, group)
        self.opt_c = _SummedAdam(self.opt_c, group)

    def _ctc_mean(self, scores, labels, lengths, rows):
        """This rank's sum of NLL / max(1, length) over `rows`, over the
        group's count of such rows."""
        n = group_sum(rows.sum().float(), self.group).clamp(min=1)
        idx = torch.nonzero(rows).flatten()
        if idx.numel() == 0:
            return scores.new_zeros(())
        nll = O.ctc_nll(scores[:, idx], labels[idx], lengths[idx])
        return (nll / lengths[idx].float().clamp(min=1)).sum() / n

    def phase_a(self, strips, mask_flat, b):
        share = super().phase_a(strips, mask_flat, b)
        return float(group_sum(torch.tensor(share, device=strips.device),
                               self.group))

    def batch_norm(self, x, sd, prefix, train, stats):
        """`reference.models.batch_norm` with the group's statistics in
        train mode."""
        if not train:
            return LOCAL_BATCH_NORM(x, sd, prefix, train, stats)
        dims = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1] * dist.get_world_size(self.group)
        mean = all_reduce(x.sum(dim=dims), group=self.group) / n
        dev = x - mean.reshape(shape)
        var = all_reduce((dev * dev).sum(dim=dims), group=self.group) / n
        if stats is not None:
            stats.append((prefix, mean.detach(), var.detach()))
        return (dev * torch.rsqrt(var.reshape(shape) + M.EPS)
                * sd[f"{prefix}.weight"].reshape(shape)
                + sd[f"{prefix}.bias"].reshape(shape))


def follow_patch(cfg, t, seed, batches, cer_tables, device, group,
                 q=None) -> dict:
    """`train.follow_patch` over the group's global batch: `batches` and
    `cer_tables` are this rank's."""
    F = Follower(cfg, t, seed, device, group, q)
    h, w = cfg["strip_size"]
    obs = dict(losses=[], masks=[], decoded=[], decoded_len=[], cer_rows=[],
               ent_rows=[], scores=[], entropy=[])
    for b, est in zip(batches, cer_tables):
        D, S = b.strip_mask.shape
        N = D * S
        with torch.no_grad():
            strips = O.gather_strips(F.unet(b.images), b.bboxes, h, w)
        if "extract" not in obs:
            obs["extract"] = strips.cpu()
        mask = O.range_cer_select(est.reshape(D, S).cpu().numpy(),
                                  b.strip_mask.cpu().numpy(),
                                  b.sel_noise.cpu().numpy(),
                                  1.0 - t["query_share"])
        mask_flat = torch.from_numpy(mask.reshape(N)).to(device)
        loss_a = F.phase_a(strips, mask_flat, b)
        del strips
        # phase B, the UNet's batch norm over the group (its recomputation
        # in the backward too)
        stats: list = []
        with mock.patch.object(M, "batch_norm", F.batch_norm):
            docs = F.unet(b.images, train=True, stats=stats,
                          checkpoint=True)
            if "train_out" not in obs:
                obs["train_out"] = docs.detach().cpu()
            strips = O.gather_strips(docs, b.bboxes, h, w)
            scores = F.crnn(strips)
            sm = b.strip_mask.reshape(N)
            nll = O.ctc_nll(scores[:, sm], b.gt_labels[sm], b.gt_lengths[sm])
            per = torch.zeros(N, device=device)
            per[sm] = nll / b.gt_lengths[sm].float().clamp(min=1)
            m = b.strip_mask.float()
            per_doc = (per.reshape(D, S) * m).sum(1) / m.sum(1).clamp(min=1)
            mse = ((docs - 1.0) ** 2).mean(dim=(1, 2, 3))
            dm = b.strip_mask.any(dim=1).float()
            loss_b = ((per_doc + t["sec_loss_scalar"] * mse) * dm).sum() \
                / group_sum(dm.sum(), group).clamp(min=1)
            params = [F.u[k] for k in F.u_names]
            grads = torch.autograd.grad(loss_b, params)
        del docs, strips
        g = dict(zip(F.u_names, grads))
        F.opt_u.step(g)
        F._note_grad(g)
        M.fold_running(F.u, stats)
        scores = scores.detach()
        dec = O.greedy_decode(scores)
        dec_t, dlen = train._pad_decoded(dec, scores.shape[0], F.pad, device)
        ent = O.entropy(scores)
        gt, gl, valid, old = (b.gt_labels.cpu(), b.gt_lengths.cpu(),
                              sm.cpu(), est.cpu())
        obs["losses"].append((loss_a, float(group_sum(loss_b, group))))
        obs["masks"].append(mask)
        obs["decoded"].append(dec_t)
        obs["decoded_len"].append(dlen)
        obs["cer_rows"].append(torch.tensor([
            O.cer(dec[r], gt[r, :int(gl[r])].tolist()) if valid[r]
            else float(old[r]) for r in range(N)], dtype=torch.float32))
        obs["ent_rows"].append(torch.where(valid, ent.cpu(), torch.ones(N)))
        obs["scores"].append(scores.cpu())
        obs["entropy"].append(ent.cpu())
        del scores
    obs["grad0"] = F.grad0
    obs["change"] = F.change()
    return obs
