"""The plain reference of the training steps the cells drive, followed from
the benchmark's weights and inputs for the first steps.

A patch step (the patch trainer's order): the UNet's eval forward and the
strip gather; rangeCER selection on the CER table; the label history and
the jitter copy of the selected strips' OCR answers; phase A, one CRNN
update (batch statistics frozen) on the decaying-weighted history CTC of
the cleaned strips plus the CTC of the jitter copy over the selected rows;
phase B, one UNet update (train-mode batch norm) on each document's mean
length-normalised CTC of its strips through the gather and the CRNN,
plus the MSE of the document to white, averaged over documents; then the
greedy decode, CER and entropy of every strip. An area step is the same on
word crops: no gather, phase B's CTC a mean over the crops plus the MSE.

`q` rounds the operands of every conv and matmul (the identity; the
control passes float8). Returns the observations `compare.training` takes.
"""

from __future__ import annotations

import torch

from portbench.reference import models as M
from portbench.reference import ops as O
from portbench.weights import crnn_schema, parameter_names, unet_schema


def _hist(b, mask_flat, pad):
    """The history targets of the selected rows (the trainer's
    `LabelHistory.gather` after this step's answer): depth i valid where it
    exists and the row was selected."""
    valid = b.hist_depth & mask_flat[:, None]
    labels = torch.where(valid[..., None], b.hist_labels, pad)
    lengths = torch.where(valid, b.hist_lengths, 0)
    return labels, lengths, valid


def _split(sd, names):
    return {k: sd[k] for k in names}


class Follower:
    """The reference's models, optimizers and tables, stepped like the
    program's."""

    def __init__(self, cfg, t, seed, device, q=None):
        from portbench.weights import make_state
        self.cfg, self.t, self.q = cfg, t, q or (lambda x: x)
        f = cfg["unet_features"]
        self.u_schema = unet_schema(f)
        self.c_schema = crnn_schema(cfg["conv_features"], cfg["lstm_hidden"],
                                    cfg["lstm_layers"], cfg["vocab_size"])
        self.u = make_state(self.u_schema, seed, 1, device)
        self.c = make_state(self.c_schema, seed, 2, device)
        self.u_names = parameter_names(self.u_schema)
        self.c_names = parameter_names(self.c_schema)
        self.p0 = {k: v.clone() for k, v in {**self.u, **self.c}.items()
                   if k in self.u_names or k in self.c_names}
        for k in self.u_names:
            self.u[k].requires_grad_(True)
        for k in self.c_names:
            self.c[k].requires_grad_(True)
        wd = t["weight_decay"]
        self.opt_u = O.Adam(_split(self.u, self.u_names), t["lr_prep"], wd)
        self.opt_c = O.Adam(_split(self.c, self.c_names), t["lr_crnn"], wd)
        self.grad0 = None
        self.pad = cfg["vocab_size"]
        self.W = t["window"]
        self.weights = torch.tensor([t["decay"] ** i for i in range(self.W)],
                                    device=device)

    def crnn(self, x):
        return M.crnn(x, self.c, self.cfg["lstm_hidden"],
                      self.cfg["lstm_layers"], self.q)

    def unet(self, x, train=False, stats=None, checkpoint=False):
        return M.unet(x, self.u, train=train, stats=stats, q=self.q,
                      checkpoint=checkpoint)

    def _ctc_mean(self, scores, labels, lengths, rows):
        """The mean over `rows` of NLL / max(1, length)."""
        idx = torch.nonzero(rows).flatten()
        if idx.numel() == 0:
            return scores.new_zeros(())
        nll = O.ctc_nll(scores[:, idx], labels[idx], lengths[idx])
        return (nll / lengths[idx].float().clamp(min=1)).mean()

    def phase_a(self, strips, mask_flat, b):
        """One CRNN update; returns the loss."""
        labels, lengths, valid = _hist(b, mask_flat, self.pad)
        jit = O.jitter(strips, b.image_std, b.unit_noise)
        rows = torch.cat([strips, jit])
        N = strips.shape[0]
        scores = self.crnn(rows)
        total = 0.0
        hist_scores, jit_scores = scores[:, :N], scores[:, N:]
        for i in range(self.W):
            total = total + self.weights[i] * self._ctc_mean(
                hist_scores, labels[:, i], lengths[:, i], valid[:, i])
        jl = torch.where(mask_flat[:, None], b.jitter_labels, self.pad)
        jlen = torch.where(mask_flat, b.jitter_lengths, 0)
        total = total + self._ctc_mean(jit_scores, jl, jlen, mask_flat)
        params = [self.c[k] for k in self.c_names]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        g = {k: (x if x is not None else torch.zeros_like(p))
             for k, x, p in zip(self.c_names, grads, params)}
        self.opt_c.step(g)
        self._note_grad(g)
        return float(total.detach())

    def _note_grad(self, g):
        if self.grad0 is None:
            self.grad0 = {}
        for k, v in g.items():
            self.grad0.setdefault(k, v.detach().clone())

    def change(self) -> dict:
        cur = {**self.u, **self.c}
        return {k: (cur[k].detach() - v) for k, v in self.p0.items()}


def _pad_decoded(dec, T, pad, device):
    out = torch.full((len(dec), T), pad, dtype=torch.int32)
    lens = torch.zeros(len(dec), dtype=torch.int32)
    for i, s in enumerate(dec):
        out[i, :len(s)] = torch.tensor(s, dtype=torch.int32)
        lens[i] = len(s)
    return out, lens


def follow_patch(cfg, t, seed, batches, cer_tables, device, q=None) -> dict:
    """The reference over `batches` (the first steps' inputs) from the
    seed's weights; `cer_tables` per step: the CER rows of the step's
    strips before it (what the selection reads)."""
    F = Follower(cfg, t, seed, device, q)
    h, w = cfg["strip_size"]
    obs = dict(losses=[], masks=[], decoded=[], decoded_len=[], cer_rows=[],
               ent_rows=[], scores=[], entropy=[])
    for b, est in zip(batches, cer_tables):
        D, S = b.strip_mask.shape
        N = D * S
        with torch.no_grad():
            docs = F.unet(b.images)
            strips = O.gather_strips(docs, b.bboxes, h, w)
            del docs
        if "extract" not in obs:
            obs["extract"] = strips.cpu()
        mask = O.range_cer_select(est.reshape(D, S).cpu().numpy(),
                                  b.strip_mask.cpu().numpy(),
                                  b.sel_noise.cpu().numpy(),
                                  1.0 - t["query_share"])
        mask_flat = torch.from_numpy(mask.reshape(N)).to(device)
        loss_a = F.phase_a(strips, mask_flat, b)
        del strips
        # phase B
        stats: list = []
        docs = F.unet(b.images, train=True, stats=stats, checkpoint=True)
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
            / dm.sum().clamp(min=1)
        params = [F.u[k] for k in F.u_names]
        grads = torch.autograd.grad(loss_b, params)
        del docs, strips
        g = dict(zip(F.u_names, grads))
        F.opt_u.step(g)
        F._note_grad(g)
        M.fold_running(F.u, stats)
        scores = scores.detach()
        dec = O.greedy_decode(scores)
        dec_t, dlen = _pad_decoded(dec, scores.shape[0], F.pad, device)
        ent = O.entropy(scores)
        gt = b.gt_labels.cpu()
        gl = b.gt_lengths.cpu()
        valid = sm.cpu()
        old = est.cpu()
        cer_rows = torch.tensor([
            O.cer(dec[r], gt[r, :int(gl[r])].tolist()) if valid[r]
            else float(old[r]) for r in range(N)], dtype=torch.float32)
        ent_rows = torch.where(valid, ent.cpu(), torch.ones(N))
        obs["losses"].append((loss_a, float(loss_b.detach())))
        obs["masks"].append(mask)
        obs["decoded"].append(dec_t)
        obs["decoded_len"].append(dlen)
        obs["cer_rows"].append(cer_rows)
        obs["ent_rows"].append(ent_rows)
        obs["scores"].append(scores.cpu())
        obs["entropy"].append(ent.cpu())
        del scores
    obs["grad0"] = F.grad0
    obs["change"] = F.change()
    return obs


def follow_area(cfg, t, seed, batches, cer_tables, device, q=None) -> dict:
    """The area steps: the UNet's eval forward on the crops, selection,
    phase A on them, phase B (CTC mean over the crops plus the MSE)."""
    F = Follower(cfg, t, seed, device, q)
    obs = dict(losses=[], masks=[], decoded=[], decoded_len=[], cer_rows=[],
               ent_rows=[], scores=[], entropy=[])
    for b, est in zip(batches, cer_tables):
        B = b.images.shape[0]
        with torch.no_grad():
            preds = F.unet(b.images)
        if "extract" not in obs:
            obs["extract"] = preds.cpu()
        mask = O.range_cer_select(est.reshape(1, B).cpu().numpy(),
                                  b.strip_mask.cpu().numpy(),
                                  b.sel_noise.cpu().numpy(),
                                  1.0 - t["query_share"])
        mask_flat = torch.from_numpy(mask.reshape(B)).to(device)
        loss_a = F.phase_a(preds, mask_flat, b)
        stats: list = []
        out = F.unet(b.images, train=True, stats=stats)
        if "train_out" not in obs:
            obs["train_out"] = out.detach().cpu()
        scores = F.crnn(out)
        nll = O.ctc_nll(scores, b.gt_labels, b.gt_lengths)
        loss_b = (nll / b.gt_lengths.float().clamp(min=1)).mean() \
            + t["sec_loss_scalar"] * ((out - 1.0) ** 2).mean()
        params = [F.u[k] for k in F.u_names]
        g = dict(zip(F.u_names, torch.autograd.grad(loss_b, params)))
        F.opt_u.step(g)
        F._note_grad(g)
        M.fold_running(F.u, stats)
        scores = scores.detach()
        dec = O.greedy_decode(scores)
        dec_t, dlen = _pad_decoded(dec, scores.shape[0], F.pad, device)
        ent = O.entropy(scores)
        gt = b.gt_labels.cpu()
        gl = b.gt_lengths.cpu()
        obs["losses"].append((loss_a, float(loss_b.detach())))
        obs["masks"].append(mask)
        obs["decoded"].append(dec_t)
        obs["decoded_len"].append(dlen)
        obs["cer_rows"].append(torch.tensor(
            [O.cer(dec[r], gt[r, :int(gl[r])].tolist()) for r in range(B)],
            dtype=torch.float32))
        obs["ent_rows"].append(ent.cpu())
        obs["scores"].append(scores.cpu())
        obs["entropy"].append(ent.cpu())
    obs["grad0"] = F.grad0
    obs["change"] = F.change()
    return obs
