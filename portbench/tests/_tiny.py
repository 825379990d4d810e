"""Cells of `BENCHMARK.json` cut to a size the CPU runs in seconds: the
CRNN's conv ladder stays whole (the program's CRNN has no other), the rest
is narrowed."""

from __future__ import annotations

import time

import torch

from portbench import harness

CONFIG = dict(unet_features=4, lstm_hidden=8, doc_size=[64, 144],
              strip_slots=3)
TRAFFIC = dict(docs=2, crops=4, pool=3, warmup_steps=1, profile_steps=1,
               warmup_requests=1, sample_requests=2)
SERVE = dict(docs=3, batch_size=3, heights=[32, 64], widths=[40, 144])


def cell(name: str, bench: dict | None = None, **kw) -> harness.Cell:
    bench = bench or harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.Cell(bench, name, **kw)
    c.config.update(CONFIG)
    c.traffic.update(TRAFFIC)
    if c.traffic["driver"] == "serve":
        # serving's UNet at its full width: on small canvases it is cheap,
        # and its readings then sit where the cell's limits were set
        c.config["unet_features"] = 32
        c.traffic.update(SERVE)
    return c


def run(c: harness.Cell, seed: int = 2 ** 31 + 11, trace: bool = False,
        seconds: float = 0.3) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(c, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda m: None)
