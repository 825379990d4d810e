"""The area trainer's step (`TrainNNPrepArea`'s order) on word crops:

  prep_forward       the UNet's eval forward on the crops
  select_batch       rangeCER on the CER table, the mask read to the host
  [benchmark]        the OCR's answers (label history, jitter labels)
  add_gaussian_noise one jitter copy of the cleaned crops
  phase_a            `make_steps(...).phase_a` (decaying weights, the
                     history round on), its loss read to the host
  phase_b            the area `phase_b` (UNet update, CRNN not updated),
                     its loss and CERs read to the host

A unit is a crop. The first `checked_steps` steps run in set-up and the
reference follows them; during them the decode that phase B writes its
CERs from is recorded for the comparison.
"""

from __future__ import annotations

import torch

from portbench import compare, counts, program, traffic
from portbench.reference import train as reference


class Driver:
    unit = "crops"

    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.config, run.traffic

    def setup(self):
        from qea_ocr_tpu_torch.ops.transforms import add_gaussian_noise
        from qea_ocr_tpu_torch.selection.samplers import select_batch
        from qea_ocr_tpu_torch.train import area_trainer
        from qea_ocr_tpu_torch.train.patch_steps import make_steps
        from qea_ocr_tpu_torch.train.state import adam_l2
        from qea_ocr_tpu_torch.utils.charmap import CharMap
        run, cfg, t = self.run, self.cfg, self.t
        dev = run.device
        self.select_batch, self.noise = select_batch, add_gaussian_noise
        self.unet, self.crnn = program.build_models(cfg, run.seed, dev)
        p0 = {**program.parameters(self.unet),
              **program.parameters(self.crnn)}
        wd = t["weight_decay"]
        self.opt_u = adam_l2(self.unet.parameters(), t["lr_prep"], wd)
        self.opt_c = adam_l2(self.crnn.parameters(), t["lr_crnn"], wd)
        cm = CharMap.default(cfg["max_label_len"])
        self.pad = cm.pad_id
        self.phase_a = make_steps(
            self.unet, self.crnn, cm, crnn_optimizer=self.opt_c,
            sec_loss_scalar=t["sec_loss_scalar"]).phase_a
        self.steps = area_trainer.make_area_steps(
            self.unet, self.crnn, cm, prep_optimizer=self.opt_u,
            crnn_optimizer=self.opt_c, sec_loss_scalar=t["sec_loss_scalar"])
        self.pool = traffic.training_pool(t, cfg, run.seed, dev)
        n_rows = sum(b.gt_lengths.numel() for b in self.pool)
        self.cer_table = traffic.cer_table(t, n_rows, run.seed, dev)
        self.ent_table = torch.ones(n_rows, device=dev)
        self.weights = torch.tensor(
            [t["decay"] ** i for i in range(t["window"])], device=dev)
        self.masks = {}
        self.check_inputs = []
        self.obs = dict(losses=[], masks=[], decoded=[], decoded_len=[])
        decode = area_trainer.greedy_decode

        def recording(scores, **kw):
            out = decode(scores, **kw)
            self.obs["decoded"].append(out[0].cpu())
            self.obs["decoded_len"].append(out[1].cpu())
            return out
        C = int(t["checked_steps"])
        area_trainer.greedy_decode = recording
        try:
            for k in range(C):
                ids = self.pool[k].strip_ids.long()
                self.check_inputs.append((self.cer_table[ids].clone(),
                                          self.ent_table[ids].clone()))
                self.step(k, keep=True)
                if k == 0:
                    self.obs["grad0"] = {
                        **program.first_gradient(self.unet, self.opt_u, wd,
                                                 p0),
                        **program.first_gradient(self.crnn, self.opt_c, wd,
                                                 p0)}
        finally:
            area_trainer.greedy_decode = decode
        now = {**program.parameters(self.unet),
               **program.parameters(self.crnn)}
        self.obs["change"] = {k: (now[k] - p0[k]).cpu() for k in now}
        self.obs["cer_rows"] = [self.cer_table[b.strip_ids.long()].cpu()
                                for b in self.pool[:C]]
        self.obs["ent_rows"] = [self.ent_table[b.strip_ids.long()].cpu()
                                for b in self.pool[:C]]
        del now, p0
        for k in range(C, C + int(t["warmup_steps"])):
            self.step(k)

    def step(self, i: int, keep: bool = False) -> int:
        run, t = self.run, self.t
        b = self.pool[i % len(self.pool)]
        B = b.images.shape[0]
        with run.span("prep_forward"):
            preds = self.steps.prep_forward(b.images)
        with run.span("select"):
            est = self.cer_table[b.strip_ids.long()].reshape(1, B)
            bb, _ = self.select_batch(t["selection"], None, est, b.strip_mask,
                                      1.0 - t["query_share"],
                                      noise=b.sel_noise)
            mask_host = bb.cpu().numpy()
        flat = bb.reshape(B)
        valid = b.hist_depth & flat[:, None]
        hist_labels = torch.where(valid[..., None], b.hist_labels, self.pad)
        hist_lengths = torch.where(valid, b.hist_lengths, 0)
        jl = torch.where(flat[:, None], b.jitter_labels, self.pad)[None]
        jlen = torch.where(flat, b.jitter_lengths, 0)[None]
        jitter, _ = self.noise(preds, t["jitter_std"], image_std=b.image_std,
                               unit_noise=b.unit_noise)
        with run.span("phase_a"):
            loss_a = float(self.phase_a(
                preds, flat, hist_labels, hist_lengths, valid, self.weights,
                jitter[None], jl, jlen, decaying=True, inner_limit_skip=True))
        with run.span("phase_b"):
            img_out, metrics, _, _ = self.steps.phase_b(
                b.images, b.gt_labels, self.cer_table, self.ent_table,
                b.gt_lengths, b.strip_ids, update_crnn=False)
            loss_b = float(metrics["loss"])
            metrics["cers"].cpu()
        if run.tracing:
            self.masks[i] = mask_host
        if keep and i == 0:
            self.obs["extract"] = preds.cpu()
            self.obs["train_out"] = img_out.cpu()
        if keep:
            self.obs["losses"].append((loss_a, loss_b))
            self.obs["masks"].append(mask_host)
        return B

    def end_to_end(self, rec) -> dict:
        return {self.t["throughput"]: rec["units"] / rec["elapsed"]}

    def work(self, profiled: int) -> dict:
        cfg, t = self.cfg, self.t
        T = cfg["strip_size"][1] // 4 - 1
        V, L = cfg["vocab_size"], cfg["max_label_len"]
        ctc = 0.0
        for i, mask in self.masks.items():
            b = self.pool[i % len(self.pool)]
            flat = torch.from_numpy(mask.reshape(-1))
            valid = b.hist_depth.cpu() & flat[:, None]
            hl = torch.where(valid, b.hist_lengths.cpu(), 0).reshape(-1)
            jl = torch.where(flat, b.jitter_lengths.cpu(), 0)
            ctc += counts.ctc_pair_bound_s(T, V, L, hl.tolist())
            ctc += counts.ctc_pair_bound_s(T, V, L, jl.tolist())
            ctc += counts.ctc_pair_bound_s(T, V, L, b.gt_lengths.tolist())
        return dict(step_flops=counts.area_step_flops(cfg, t["crops"], 1),
                    ctc_bound_s=ctc)

    def release(self):
        for name in ("steps", "phase_a", "unet", "crnn", "opt_u", "opt_c",
                     "cer_table", "ent_table"):
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
                            [True] * len(gl)))
        with program.exact_float32():
            ref = reference.follow_area(cfg, t, run.seed, batches, tables,
                                        run.device)
            ctl = None if control is None else reference.follow_area(
                cfg, t, run.seed, batches, tables, run.device, q=control)
        values = compare.training(self.obs, ref, gt_rows, self.check_inputs)
        self.detail = {"program": compare.training_detail(self.obs, ref)}
        if ctl is None:
            return values, None
        self.detail["control"] = compare.training_detail(ctl, ref)
        return values, compare.training(ctl, ref, gt_rows, self.check_inputs)
