"""Serving: one client in a closed loop, each request
`DocumentCleaner.clean_arrays_uint8` on `docs` documents of varied sizes
(white-padded into the canvas, cleaned in one batch, cropped back). The
requests are a pool made before the window and cycled. A unit is a
document; a request's latency is its call's host time.

After the window a sample of the requests it completed, drawn from the
seed, is compared with the reference's float32 UNet on the same canvases.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, counts, program, traffic
from portbench.weights import make_state, unet_schema


class Driver:
    unit = "docs"

    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.config, run.traffic

    def setup(self):
        from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
        run, cfg, t = self.run, self.cfg, self.t
        self.cleaner = DocumentCleaner(
            state_dict=make_state(unet_schema(cfg["unet_features"]),
                                  run.seed, 1, run.device),
            device=run.device, batch_size=t["batch_size"],
            doc_size=tuple(cfg["doc_size"]),
            unet_features=cfg["unet_features"])
        # the cleaner takes no policy: refuse one it does not run
        program.check_policy(self.cleaner.model, cfg)
        self.pool = traffic.serve_pool(t, run.seed, run.device)
        self.outputs = {}
        for i in range(int(t["warmup_requests"])):
            self.step(i)
        self.outputs = {}

    def step(self, i: int) -> int:
        docs = self.pool[i % len(self.pool)]
        with self.run.span("clean"):
            out = self.cleaner.clean_arrays_uint8(docs)
        self.outputs[i] = out
        return len(docs)

    def end_to_end(self, rec) -> dict:
        lat = np.asarray(rec["latencies"]) * 1e3
        return {self.t["throughput"]: rec["units"] / rec["elapsed"],
                self.t["latency_p95"]: float(np.percentile(lat, 95))}

    def work(self, profiled: int) -> dict:
        cfg, t = self.cfg, self.t
        H, W = cfg["doc_size"]
        f = cfg["unet_features"]
        per_request = sum(counts.conv_cmajor_bound_s(t["batch_size"], *c)
                          for c in counts.unet_cmajor_convs(f, H, W))
        return dict(step_flops=counts.unet_forward_flops(cfg,
                                                         t["batch_size"]),
                    conv_bound_s=per_request * profiled)

    def release(self):
        self.cleaner = None

    def check(self) -> list:
        return compare.judged(self.readings()[0], self.run.cell.limits)

    def readings(self, control=None):
        """The sampled requests' documents against the reference's float32
        UNet on the same canvases; given a rounding `control`, the
        reference at that precision, quantised to uint8 as the service
        returns it, in the program's place."""
        from portbench.reference import models as M
        from portbench.reference.serve import canvas
        run, cfg, t = self.run, self.cfg, self.t
        done = sorted(self.outputs)
        g = traffic.generator(run.seed, "sample", "cpu")
        pick = torch.randperm(len(done), generator=g)[:t["sample_requests"]]
        sd = make_state(unet_schema(cfg["unet_features"]), run.seed, 1,
                        run.device)
        H, W = cfg["doc_size"]
        acc = {"prog": [0.0, 0, 0.0, 0], "ctl": [0.0, 0, 0.0, 0]}

        def add(key, out, want):
            a = acc[key]
            if tuple(out.shape) != tuple(want.shape):
                a[3] += 1
                return
            d = (out.float() - want).abs()
            a[0] += float(d.sum())
            a[1] += d.numel()
            a[2] = max(a[2], float(d.max()))
        with program.exact_float32(), torch.no_grad():
            for j in pick.tolist():
                i = done[j]
                docs = self.pool[i % len(self.pool)]
                got = self.outputs[i]
                x, geoms = canvas(docs, H, W, run.device)
                for a in range(0, len(docs), 8):
                    ref = M.unet(x[a:a + 8], sd)[:, 0] * 255.0
                    alt = None if control is None else torch.round(
                        M.unet(x[a:a + 8], sd, q=control)[:, 0] * 255.0
                    ).clamp(0, 255)
                    for r in range(a, min(a + 8, len(docs))):
                        top, left, h, w = geoms[r]
                        want = ref[r - a, top:top + h, left:left + w]
                        add("prog", torch.from_numpy(np.asarray(got[r])).to(
                            run.device), want)
                        if alt is not None:
                            add("ctl", alt[r - a, top:top + h,
                                           left:left + w], want)

        def values(a):
            return [("pixel_mean_gap", a[0] / max(a[1], 1)),
                    ("pixel_max_gap", a[2]), ("shape_diff", float(a[3]))]
        return values(acc["prog"]), (None if control is None
                                     else values(acc["ctl"]))
