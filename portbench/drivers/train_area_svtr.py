"""The area trainer's step (`drivers/train_area.py`, the same order and
the same step functions) with SVTR in the proxy's place: phase A trains it
on 2 x B rows (the cleaned crops and their jitter copy) in one call, phase B
takes its input gradient for the UNet on B rows.

The program's models are the UNet and `models/svtr.py`'s SVTR at the
configuration's widths, with the benchmark's weights for the seed; the
reference is `reference/train_svtr.py`. `work` adds the attention's least
time (`counts_svtr.attention_bound_s`) over the profiled steps.

One number beside `compare.training`'s judges the proxy alone, before any
update moves it:

  logprob_gap  mean |program - reference| of the log-probs of SVTR's first
               call (phase A of the first step, 2 x B rows), the reference
               in float32 on the program's own input rows and the seed's
               weights

The later numbers read the models after Adam's first updates, whose size
is the learning rate whatever the gradient: where a gradient is within
rounding of nought the two runs step apart, and over three steps they
part further than the CRNN cells' do. `entropy_gap` is left out here: on
some seeds SVTR's bfloat16 rounding alone parts the runs' third-step
entropies as far as any planted fault does (the program in float32 follows
the reference to 4e-5 on such a seed), so no limit separates the two
(`PERF.md` §6).
"""

from __future__ import annotations

from types import SimpleNamespace
from unittest import mock

import torch

from portbench import counts, counts_svtr, program
from portbench.drivers import train_area as base
from portbench.reference import svtr as S
from portbench.reference import train_svtr
from portbench.weights import make_state, unet_schema
from portbench.weights_svtr import arch, svtr_schema


def build_models(cfg: dict, seed: int, device):
    """The program's UNet and SVTR on `device`, holding the benchmark's
    weights for `seed`, in the configuration's compute policy."""
    from qea_ocr_tpu_torch.models.svtr import SVTR
    from qea_ocr_tpu_torch.models.unet import UNet
    gen = torch.Generator(device=device).manual_seed(0)
    dt = program.compute_dtype(cfg)
    a = arch(cfg)
    h, w = cfg["strip_size"]
    with torch.device(device):
        unet = UNet(init_features=cfg["unet_features"], compute_dtype=dt,
                    generator=gen)
        unet.load_state_dict(make_state(unet_schema(cfg["unet_features"]),
                                        seed, 1, device), strict=True)
        program.check_policy(unet, cfg)
        proxy = SVTR(cfg["vocab_size"], dims=a["dims"], depths=a["depths"],
                     heads=a["heads"], local_blocks=a["local_blocks"],
                     out_channels=a["out_channels"], window=a["window"],
                     mlp_ratio=a["mlp_ratio"], eps=cfg["epsilon"],
                     image_size=(h, w), compute_dtype=dt,
                     generator=gen)
        proxy.load_state_dict(make_state(
            svtr_schema(a, cfg["vocab_size"], (h // 4, w // 4)), seed,
            train_svtr.PROXY_SALT, device), strict=True)
        program.check_policy(proxy, cfg)
    return unet, proxy


class Driver(base.Driver):
    ROW_BLOCK = 256     # rows a reference forward takes at a time
    LEFT_OUT = ("entropy_gap",)

    def setup(self):
        def build(cfg, seed, device):
            unet, proxy = build_models(cfg, seed, device)
            hooks.append(proxy.register_forward_hook(self._keep_first))
            return unet, proxy
        hooks, self.first = [], None
        with mock.patch.object(program, "build_models", build):
            super().setup()
        hooks[0].remove()

    def _keep_first(self, module, args, out):
        if self.first is None:
            self.first = (args[0].detach().cpu(), out.detach().cpu())

    def work(self, profiled: int) -> dict:
        cfg, t = self.cfg, self.t
        h, w = cfg["strip_size"]
        T = w // 4
        V, L = cfg["vocab_size"], cfg["max_label_len"]
        B = t["crops"]
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
        # a step: phase A's 2 B rows and phase B's B rows, each forward and
        # backward
        attn = len(self.masks) * counts_svtr.attention_bound_s(
            arch(cfg), 3 * B, (h // 4, w // 4))
        return dict(step_flops=counts_svtr.area_step_flops(cfg, B, 1),
                    ctc_bound_s=ctc, attn_bound_s=attn)

    def readings(self, control=None):
        with mock.patch.object(base, "reference", SimpleNamespace(
                follow_area=train_svtr.follow_area)):
            values, ctl = super().readings(control)
        values = [v for v in values if v[0] not in self.LEFT_OUT]
        values.append(("logprob_gap", self.logprob_gap()))
        if ctl is not None:
            ctl = [v for v in ctl if v[0] not in self.LEFT_OUT]
            ctl.append(("logprob_gap", self.logprob_gap(control)))
        return values, ctl

    def logprob_gap(self, control=None) -> float:
        """`logprob_gap` of the program's first SVTR call or, given a
        rounding `control`, of the reference at that precision on the same
        rows."""
        cfg, dev = self.cfg, self.run.device
        a = arch(cfg)
        h, w = cfg["strip_size"]
        sd = make_state(svtr_schema(a, cfg["vocab_size"], (h // 4, w // 4)),
                        self.run.seed, train_svtr.PROXY_SALT, dev)
        rows, scores = self.first
        total = 0.0
        with torch.no_grad(), program.exact_float32():
            for at in range(0, rows.shape[0], self.ROW_BLOCK):
                x = rows[at:at + self.ROW_BLOCK].to(dev)
                ref = S.svtr(x, sd, a)
                got = (scores[:, at:at + self.ROW_BLOCK].to(dev)
                       if control is None else S.svtr(x, sd, a, control))
                total += float((got - ref).abs().sum())
        return total / scores.numel()
