"""The patch step (`drivers/train_patch.py`) over a data-parallel group of
`ranks` processes, one card each: every rank draws its own documents,
and the step functions (`make_steps(group=WORLD)`) compute one step over
the global batch through `parallel/multihost.py` (global counts and batch
statistics, summed gradients, every rank's rows in the tables). A unit is
a document of the global batch.

The harness's process is rank 0. Its `setup` starts ranks 1 .. ranks-1
(`python3 -m portbench.drivers.train_patch_dp4`, card r each), and each
rank then runs the same set-up: the steps the reference follows and the
warm-up steps. After that the other ranks wait for rank 0's word: before
each of its timed or profiled steps rank 0 sends the step's index on a
Gloo group, and `release` sends the word to stop. Then every rank frees
its program and runs the reference of the global step
(`reference/train_dp.py`) and the comparison on its own rows; each number
judged is the worst rank's. Only rank 0 is timed and profiled.

One number beside `compare.training`'s judges the exchanges between the
ranks themselves:

  replica_gap  the largest |difference| between a rank's parameters and
               batch-norm statistics and rank 0's at the end of set-up
               (exact: every rank applies the same summed gradient and
               moves its statistics by the same global sums)

No rank waits forever. Rank 0 watches its children: one that exits before
the end, or with an error, ends rank 0's process at once with an error.
A child ends itself when rank 0's process is gone. The process group's
start (`start_timeout_s`) and each wait for rank 0's word or a collective
(`wait_timeout_s`) have their own limits.

The readings the limits are set from (`portbench/control_dp4.py`) need
every rank to plant the same fault and follow the same control: the
children read both from the environment they inherit (`FAULT_VAR`,
`CONTROL_VAR`).
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from unittest import mock

import torch
import torch.distributed as dist

from portbench import compare, faults_dp4, harness, program, traffic
from portbench.drivers import train_patch as base
from portbench.reference import precision, train_dp

STEP, STOP = 1, 0
FAULT_VAR = "PORTBENCH_DP_FAULT"      # the fault every rank plants
CONTROL_VAR = "PORTBENCH_DP_CONTROL"  # "1": every rank reads the control


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_when(dead, message: str, code: int) -> None:
    """A daemon thread that ends this process at once when `dead()`."""
    def watch():
        while True:
            if dead():
                print(f"[dp] {message}", file=sys.stderr, flush=True)
                os._exit(code)
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True).start()


class Driver(base.Driver):

    def __init__(self, run, rank: int = 0, port: int | None = None):
        super().__init__(run)
        self.rank, self.port = rank, port
        self.world = int(self.t["ranks"])
        self.children: list = []
        self.stepping = False
        self.finished = False

    # ------------------------------------------------------------ the group
    def _start_ranks(self) -> None:
        """Ranks 1 .. world-1 in processes of their own, their output on
        this process's standard error."""
        self.port = _free_port()
        cell = json.dumps({"name": self.run.cell.name,
                           "config": self.cfg, "traffic": self.t,
                           "limits": self.run.cell.limits})
        for r in range(1, self.world):
            self.children.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.drivers.train_patch_dp4",
                 "--rank", str(r), "--port", str(self.port),
                 "--seed", str(self.run.seed),
                 "--device", self.run.device.type, "--cell", cell],
                cwd=harness.ROOT, stdout=sys.stderr, stderr=sys.stderr))
        _exit_when(lambda: not self.finished and any(
            p.poll() is not None for p in self.children),
            "a rank ended before the run did", 5)

    def _join_group(self) -> None:
        dev = self.run.device
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{self.port}",
            world_size=self.world, rank=self.rank,
            timeout=datetime.timedelta(seconds=self.t["start_timeout_s"]),
            **kw)
        wait = datetime.timedelta(seconds=self.t["wait_timeout_s"])
        self.ctl = dist.new_group(backend="gloo", timeout=wait)
        self.group = dist.group.WORLD

    def _word(self, cmd: int = STEP, i: int = 0):
        """Rank 0's word to the others: (command, step index)."""
        w = torch.tensor([cmd, i], dtype=torch.int64)
        dist.broadcast(w, src=0, group=self.ctl)
        return int(w[0]), int(w[1])

    # ------------------------------------------------------------- set-up
    def setup(self):
        """`train_patch.Driver.setup` on this rank: its own documents (the
        pool drawn from the rank's seed, strip ids after the lower ranks'),
        the global CER and entropy tables, and the steps over the group."""
        from qea_ocr_tpu_torch.ops.transforms import add_gaussian_noise
        from qea_ocr_tpu_torch.selection.samplers import select_batch
        from qea_ocr_tpu_torch.train.patch_steps import make_steps
        from qea_ocr_tpu_torch.train.state import adam_l2
        from qea_ocr_tpu_torch.utils.charmap import CharMap
        if self.rank == 0:
            self._start_ranks()
        self._join_group()
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
            sec_loss_scalar=t["sec_loss_scalar"], group=self.group)
        self.pool = traffic.training_pool(
            t, cfg, run.seed * self.world + self.rank, dev)
        n_rows = sum(b.gt_lengths.numel() for b in self.pool)
        for b in self.pool:
            b.strip_ids += self.rank * n_rows
        self.cer_table = traffic.cer_table(t, self.world * n_rows, run.seed,
                                           dev)
        self.ent_table = torch.ones(self.world * n_rows, device=dev)
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
        self.replica = torch.cat([
            v.detach().reshape(-1).double().cpu()
            for m in (self.unet, self.crnn) for v in m.state_dict().values()])
        self.stepping = self.rank == 0

    # -------------------------------------------------------------- steps
    def step(self, i: int, keep: bool = False) -> int:
        """One step of the global batch; rank 0 first tells the others."""
        if self.stepping:
            self._word(STEP, i)
        return self.world * super().step(i, keep)

    def follow(self) -> None:
        """Ranks other than 0: rank 0's steps, until its word to stop."""
        while True:
            cmd, i = self._word()
            if cmd == STOP:
                return
            self.step(i)

    def release(self):
        if self.stepping:
            self._word(STOP)
            self.stepping = False
        super().release()

    # --------------------------------------------------------- comparison
    def check(self) -> list:
        """Every rank's numbers against the reference of the global step,
        each judged by the worst rank's; then the group ends."""
        control = (precision.control(self.cfg)
                   if os.environ.get(CONTROL_VAR) == "1" else None)
        values = self.readings(control)[0]
        dist.destroy_process_group()
        for r, p in enumerate(self.children, start=1):
            if p.wait(timeout=self.t["wait_timeout_s"]):
                raise RuntimeError(f"rank {r} exited with {p.returncode}")
        return compare.judged(values, self.run.cell.limits)

    def readings(self, control=None):
        """`train_patch.Driver.readings` against the reference of the
        global step, each number the worst rank's (every rank calls it with
        the same `control`); after it the ranks may end."""
        with mock.patch.object(base, "reference", SimpleNamespace(
                follow_patch=functools.partial(train_dp.follow_patch,
                                               group=self.group))):
            values, ctl = super().readings(control)
        values = self._worst(values + [("replica_gap", self._replica_gap())])
        ctl = None if ctl is None else self._worst(ctl)
        self.finished = True
        return values, ctl

    def _replica_gap(self) -> float:
        """`replica_gap` of this rank."""
        first = self.replica.clone()
        dist.broadcast(first, src=0, group=self.ctl)
        return float((self.replica - first).abs().max())

    def _worst(self, values: list) -> list:
        worst = torch.tensor([v for _, v in values], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=self.ctl)
        return [(n, float(v)) for (n, _), v in zip(values, worst)]


class _Cell:
    """The parts of `harness.Cell` a rank reads, from rank 0's."""

    def __init__(self, d: dict):
        self.name, self.config = d["name"], d["config"]
        self.traffic, self.limits = d["traffic"], d["limits"]


def main(argv=None) -> int:
    """A rank other than 0, started by rank 0's `setup`."""
    p = argparse.ArgumentParser(description="one rank of a data-parallel "
                                "cell, started by rank 0")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--cell", required=True)
    args = p.parse_args(argv)
    parent = os.getppid()
    _exit_when(lambda: os.getppid() != parent, "rank 0 is gone", 6)
    cell = _Cell(json.loads(args.cell))
    harness.set_environment({**cell.config.get("env", {}),
                             **cell.traffic.get("env", {})})
    torch.set_num_threads(4 if args.device == "cuda" else 1)
    dev = torch.device("cuda", args.rank) if args.device == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    driver = Driver(harness.Run(cell, args.seed, dev), args.rank, args.port)
    with faults_dp4.planted(os.environ.get(FAULT_VAR) or None):
        driver.setup()
    driver.follow()
    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    driver.check()
    return 0


if __name__ == "__main__":
    sys.exit(main())
