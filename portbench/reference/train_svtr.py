"""The plain reference of the area steps with SVTR as the proxy: the area
reference (`reference/train.py`: `follow_area`) with SVTR
(`reference/svtr.py`, float32, each block recomputed in the backward so
that 2 x 512 rows fit) in the CRNN's place. The weights are the
benchmark's from the seed (`weights_svtr.py`), the proxy's under the
CRNN's salt."""

from __future__ import annotations

from unittest import mock

import torch

from portbench.reference import ops as O
from portbench.reference import svtr as S
from portbench.reference import train
from portbench.weights import make_state, parameter_names, unet_schema
from portbench.weights_svtr import arch, svtr_schema

PROXY_SALT = 2


class Follower(train.Follower):
    """`train.Follower` whose proxy is SVTR."""

    def __init__(self, cfg, t, seed, device, q=None):
        self.cfg, self.t, self.q = cfg, t, q or (lambda x: x)
        self.arch = arch(cfg)
        h, w = cfg["strip_size"]
        self.u_schema = unet_schema(cfg["unet_features"])
        self.c_schema = svtr_schema(self.arch, cfg["vocab_size"],
                                    (h // 4, w // 4))
        self.u = make_state(self.u_schema, seed, 1, device)
        self.c = make_state(self.c_schema, seed, PROXY_SALT, device)
        self.u_names = parameter_names(self.u_schema)
        self.c_names = parameter_names(self.c_schema)
        self.p0 = {k: v.clone() for k, v in {**self.u, **self.c}.items()
                   if k in self.u_names or k in self.c_names}
        for k in self.u_names:
            self.u[k].requires_grad_(True)
        for k in self.c_names:
            self.c[k].requires_grad_(True)
        wd = t["weight_decay"]
        self.opt_u = O.Adam(train._split(self.u, self.u_names), t["lr_prep"],
                            wd)
        self.opt_c = O.Adam(train._split(self.c, self.c_names), t["lr_crnn"],
                            wd)
        self.grad0 = None
        self.pad = cfg["vocab_size"]
        self.W = t["window"]
        self.weights = torch.tensor([t["decay"] ** i for i in range(self.W)],
                                    device=device)

    def crnn(self, x):
        return S.svtr(x, self.c, self.arch, self.q, checkpoint=True)


def follow_area(cfg, t, seed, batches, cer_tables, device, q=None) -> dict:
    """`train.follow_area` with this module's `Follower`."""
    with mock.patch.object(train, "Follower", Follower):
        return train.follow_area(cfg, t, seed, batches, cer_tables, device,
                                 q)
