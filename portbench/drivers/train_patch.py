"""The patch trainer's step (`TrainNNPrep`'s order), timed step by step:

  prep_extract       UNet eval forward and strip gather
  select_batch       rangeCER on the CER table, then the mask read to the
                     host (the trainer's sync point for its OCR queries)
  [benchmark]        the OCR's answers for the selected strips: the label
                     history and the jitter copy's labels, from the seed
                     (the paid OCR lies outside the system)
  add_gaussian_noise one jitter copy of the cleaned strips
  phase_ab           phase A then phase B (decaying weights, the history
                     round on, the CRNN not updated in phase B), then both
                     losses read to the host as the trainer does

A unit is a document. The first `checked_steps` steps run in set-up on
batches of different strips, and the reference follows them.
"""

from __future__ import annotations

import torch

from portbench import compare, counts, program, traffic
from portbench.reference import train as reference

class Driver:
    unit = "docs"

    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.config, run.traffic

    # ------------------------------------------------------------- set-up
    def setup(self):
        from qea_ocr_tpu_torch.ops.transforms import add_gaussian_noise
        from qea_ocr_tpu_torch.selection.samplers import select_batch
        from qea_ocr_tpu_torch.train.patch_steps import make_steps
        from qea_ocr_tpu_torch.train.state import adam_l2
        from qea_ocr_tpu_torch.utils.charmap import CharMap
        run, cfg, t = self.run, self.cfg, self.t
        dev = run.device
        self.select_batch, self.noise = select_batch, add_gaussian_noise
        self.unet, self.crnn = program.build_models(cfg, run.seed, dev)
        self.p0 = {**program.parameters(self.unet),
                   **program.parameters(self.crnn)}
        wd = t["weight_decay"]
        self.opt_u = adam_l2(self.unet.parameters(), t["lr_prep"], wd)
        self.opt_c = adam_l2(self.crnn.parameters(), t["lr_crnn"], wd)
        cm = CharMap.default(cfg["max_label_len"])
        self.pad = cm.pad_id
        self.steps = make_steps(
            self.unet, self.crnn, cm, prep_optimizer=self.opt_u,
            crnn_optimizer=self.opt_c, h_out=cfg["strip_size"][0],
            w_out=cfg["strip_size"][1],
            sec_loss_scalar=t["sec_loss_scalar"])
        self.pool = traffic.training_pool(t, cfg, run.seed, dev)
        n_rows = sum(b.gt_lengths.numel() for b in self.pool)
        self.cer_table = traffic.cer_table(t, n_rows, run.seed, dev)
        self.ent_table = torch.ones(n_rows, device=dev)
        self.weights = torch.tensor(
            [t["decay"] ** i for i in range(t["window"])], device=dev)
        self.masks = {}
        self.check_inputs = []
        self.obs = dict(losses=[], masks=[], decoded=[], decoded_len=[])
        C = int(t["checked_steps"])
        for k in range(C):
            ids = self.pool[k].strip_ids.long()
            self.check_inputs.append(
                (self.cer_table[ids].clone(), self.ent_table[ids].clone()))
            self.step(k, keep=True)
            if k == 0:
                self.obs["grad0"] = {
                    **program.first_gradient(self.unet, self.opt_u, wd,
                                             self.p0),
                    **program.first_gradient(self.crnn, self.opt_c, wd,
                                             self.p0)}
        now = {**program.parameters(self.unet),
               **program.parameters(self.crnn)}
        self.obs["change"] = {k: (now[k] - self.p0[k]).cpu() for k in now}
        self.obs["cer_rows"] = [self.cer_table[b.strip_ids.long()].cpu()
                                for b in self.pool[:C]]
        self.obs["ent_rows"] = [self.ent_table[b.strip_ids.long()].cpu()
                                for b in self.pool[:C]]
        del now, self.p0
        for k in range(C, C + int(t["warmup_steps"])):
            self.step(k)

    # --------------------------------------------------------------- step
    def step(self, i: int, keep: bool = False) -> int:
        run, t = self.run, self.t
        b = self.pool[i % len(self.pool)]
        D, S = b.strip_mask.shape
        N = D * S
        with run.span("prep_extract"):
            _, strips = self.steps.prep_extract(b.images, b.bboxes)
        with run.span("select"):
            est = self.cer_table[b.strip_ids.long()].reshape(D, S)
            bb, _ = self.select_batch(t["selection"], None, est, b.strip_mask,
                                      1.0 - t["query_share"],
                                      noise=b.sel_noise)
            mask_host = bb.cpu().numpy()
        flat = bb.reshape(N)
        valid = b.hist_depth & flat[:, None]
        hist_labels = torch.where(valid[..., None], b.hist_labels, self.pad)
        hist_lengths = torch.where(valid, b.hist_lengths, 0)
        jl = torch.where(flat[:, None], b.jitter_labels, self.pad)[None]
        jlen = torch.where(flat, b.jitter_lengths, 0)[None]
        jitter, _ = self.noise(strips, t["jitter_std"], image_std=b.image_std,
                               unit_noise=b.unit_noise)
        with run.span("phase_ab"):
            doc_out, metrics, _, _, loss_a = self.steps.phase_ab(
                b.images, b.bboxes, b.strip_mask, b.gt_labels.reshape(
                    D, S, -1), self.cer_table, self.ent_table,
                b.gt_lengths.reshape(D, S), b.strip_ids.reshape(D, S),
                strips, flat, hist_labels, hist_lengths, valid,
                self.weights, jitter[None], jl, jlen, decaying=True,
                inner_limit_skip=True, update_crnn=False)
            losses = (float(loss_a), float(metrics["loss"]))
        if run.tracing:
            self.masks[i] = mask_host
        if keep and i == 0:
            self.obs["extract"] = strips.cpu()
            self.obs["train_out"] = doc_out.cpu()
        if keep:
            self.obs["losses"].append(losses)
            self.obs["masks"].append(mask_host)
            self.obs["decoded"].append(metrics["decoded"].cpu())
            self.obs["decoded_len"].append(metrics["decoded_len"].cpu())
        return D

    # ------------------------------------------------------------ results
    def end_to_end(self, rec) -> dict:
        return {self.t["throughput"]: rec["units"] / rec["elapsed"]}

    def work(self, profiled: int) -> dict:
        """Model FLOPs of a step; the CTC and gather bounds of the steps
        that were profiled, from their inputs and selections."""
        cfg, t = self.cfg, self.t
        D = t["docs"]
        S = cfg["strip_slots"]
        H, W = cfg["doc_size"]
        T = cfg["strip_size"][1] // 4 - 1
        V, L = cfg["vocab_size"], cfg["max_label_len"]
        ctc = gather = 0.0
        for i, mask in self.masks.items():
            b = self.pool[i % len(self.pool)]
            flat = torch.from_numpy(mask.reshape(-1)).to(b.hist_depth.device)
            valid = (b.hist_depth & flat[:, None]).cpu()
            hl = torch.where(valid, b.hist_lengths.cpu(), 0).reshape(-1)
            jl = torch.where(flat.cpu(), b.jitter_lengths.cpu(), 0)
            ctc += counts.ctc_pair_bound_s(T, V, L, hl.tolist())
            ctc += counts.ctc_pair_bound_s(T, V, L, jl.tolist())
            ctc += counts.ctc_pair_bound_s(T, V, L, b.gt_lengths.tolist())
            bx = b.bboxes.long().cpu()
            area = int(((bx[..., 2] - bx[..., 0]).clamp(0, 128)
                        * (bx[..., 3] - bx[..., 1]).clamp(0, 32)).sum())
            gather += 2 * counts.gather_fwd_bound_s(D, S, area) \
                + counts.gather_bwd_bound_s(D, S, area, H, W)
        return dict(step_flops=counts.patch_step_flops(cfg, D, 1),
                    ctc_bound_s=ctc, gather_bound_s=gather)

    def release(self):
        for name in ("steps", "unet", "crnn", "opt_u", "opt_c", "cer_table",
                     "ent_table"):
            setattr(self, name, None)

    def check(self) -> list:
        return compare.judged(self.readings()[0], self.run.cell.limits)

    def readings(self, control=None):
        """The numbers compared for the program and, given a rounding
        `control`, for the reference run at that precision in the
        program's place."""
        run, cfg, t = self.run, self.cfg, self.t
        C = int(t["checked_steps"])
        batches = self.pool = self.pool[:C]
        tables = [c for c, _ in self.check_inputs]
        gt_rows = []
        for b in batches:
            gl, gt = b.gt_lengths.cpu(), b.gt_labels.cpu()
            gt_rows.append(([gt[r, :int(gl[r])].tolist()
                             for r in range(len(gl))],
                            b.strip_mask.reshape(-1).cpu().tolist()))
        with program.exact_float32():
            ref = reference.follow_patch(cfg, t, run.seed, batches, tables,
                                         run.device)
            ctl = None if control is None else reference.follow_patch(
                cfg, t, run.seed, batches, tables, run.device, q=control)
        values = compare.training(self.obs, ref, gt_rows, self.check_inputs)
        self.detail = {"program": compare.training_detail(self.obs, ref)}
        if ctl is None:
            return values, None
        self.detail["control"] = compare.training_detail(ctl, ref)
        return values, compare.training(ctl, ref, gt_rows, self.check_inputs)
