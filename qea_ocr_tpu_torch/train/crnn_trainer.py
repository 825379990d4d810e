"""CRNN warmup trainer: supervised CTC training of the proxy alone
(counterpart of `qea_ocr_tpu/train/crnn_trainer.py`).

Counterpart of reference `train_crnn.py:28-214` ("learn the OCR's outputs"):
labels come from a black-box OCR on the (noisy) training crops when an OCR
is configured, else from GT filenames; clean validation with greedy-decode
accuracy; StepLR(step=10, gamma=0.8); best + final checkpoints.

One train step (the CRNN's train-mode forward, whose batch statistics move
by flax's rule; the CTC loss through the hand-written alpha and beta
kernels on a CUDA device; non-finite gradients zeroed, the reference's NaN
backward hook, `model_crnn.py:30-32`; Adam without decay) and one eval step
(CTC loss with a sample mask, greedy decode, device CER). The black-box
boundary is the host OCR call per batch; the loss is read on the host every
step, as in the JAX package.

Data parallelism (`data_parallel`, JAX `crnn_trainer.py:131-170`): under a
`torch.distributed` process group (`parallel.multihost.
maybe_init_distributed`) `batch_size` is the global batch; each rank owns a
pinned subset of the crops, loads and OCRs only its `batch_size / world`
rows a step, and runs the step over the global batch (global batch
statistics and loss count, gradients summed); validation windows are split
the same way, an empty slice feeding a blank batch, and every metric is a
global sum. Rank 0 writes the metrics and checkpoints. Without a group it
is a world of one.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import ImgDataset, SyntheticWordDataset
from qea_ocr_tpu_torch.data.pipeline import (
    WordBatch, batch_iterator, blank_wordbatch, collate_words,
    default_num_workers, pad_wordbatch)
from qea_ocr_tpu_torch.models.proxy import build_proxy
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.transforms import host_jitter
from qea_ocr_tpu_torch.parallel.mesh import make_mesh, put_replicated
from qea_ocr_tpu_torch.parallel.multihost import (
    data_group, global_count, pinned_subset, process_shard, process_sum,
    rank_device, reported, sum_gradients)
from qea_ocr_tpu_torch.train.state import (
    adam_l2, scrub_nonfinite, set_learning_rate, step_lr)
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import load_checkpoint, save_checkpoint
from qea_ocr_tpu_torch.utils.metrics import MetricsLogger, StepTimer


@dataclasses.dataclass
class CrnnTrainerConfig:
    batch_size: int = 32
    lr: float = 1e-4
    epochs: int = 50
    std: int = 5
    random_std: bool = True
    random_seed: int = 42
    ocr: Optional[str] = None          # None -> GT labels from filenames
    dataset: str = "pos"               # pos | vgg | synthetic
    data_base_path: str = "."
    train_subset: Optional[int] = None
    val_subset: Optional[int] = None
    crnn_model_path: str = "./outputs/crnn_trained_model/model"
    ckpt_path: Optional[str] = None    # resume checkpoint
    start_epoch: int = -1
    decay: float = 0.8
    decay_step: int = 10
    # architecture overrides (tests use small models)
    lstm_hidden: int = 256
    # synthetic-world knobs
    synthetic_train_size: int = 256
    synthetic_val_size: int = 64
    corruption: Optional[dict] = None
    log_dir: Optional[str] = None
    data_parallel: bool = False  # shard the crop batch over the ranks of
                                 # the process group (a world of one
                                 # without a group)
    # the port's additions
    proxy: str = "crnn"    # models/proxy.py: crnn or svtr-l
    device: str = "cuda"   # torch device; a missing GPU is an error


class TrainCRNN:
    def __init__(self, cfg: CrnnTrainerConfig):
        self.cfg = cfg
        self.device = resolve_device(rank_device(cfg.device))
        # ----------------------------------------------------- topology
        self.group = None
        self._pi, self._pc = 0, 1
        if cfg.data_parallel:
            self._pi, self._pc = process_shard()
            if dist.is_initialized():
                self.group = dist.group.WORLD
            if cfg.batch_size % self._pc:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must be a multiple of the "
                    f"device count {self._pc} for data_parallel mode")
        self._bl = cfg.batch_size // self._pc     # local crops a step
        self.charmap = CharMap.default()
        np.random.seed(cfg.random_seed)
        self._np_rng = np.random.default_rng(cfg.random_seed)

        # ----------------------------------------------------------- data
        if cfg.dataset == "synthetic":
            corruption = cfg.corruption
            self.train_ds = SyntheticWordDataset(
                cfg.synthetic_train_size, seed=cfg.random_seed,
                corruption=corruption)
            self.val_ds = SyntheticWordDataset(
                cfg.synthetic_val_size, seed=cfg.random_seed + 1,
                corruption=corruption)
        else:
            split = {
                "pos": (C.POS_TEXT_TRAIN, C.POS_TEXT_DEV),
                "vgg": (C.VGG_TEXT_TRAIN, C.VGG_TEXT_DEV),
            }[cfg.dataset]
            self.train_ds = ImgDataset(
                os.path.join(cfg.data_base_path, split[0]),
                num_subset=cfg.train_subset)
            self.val_ds = ImgDataset(
                os.path.join(cfg.data_base_path, split[1]),
                num_subset=cfg.val_subset)

        backend = get_ocr_helper(cfg.ocr)
        self.ocr = OcrQueryEngine(backend, self.charmap) if backend else None

        # ----------------------------------------------------------- model
        self.model = build_proxy(
            cfg.proxy, self.charmap.vocab_size, lstm_hidden=cfg.lstm_hidden,
            generator=torch.Generator().manual_seed(cfg.random_seed)
        ).to(self.device)
        self.optimizer = adam_l2(self.model.parameters(), cfg.lr,
                                 weight_decay=0.0)
        if cfg.ckpt_path:
            # parameters and batch statistics with a fresh optimizer, as the
            # JAX package restores (`load_checkpoint` there without
            # restore_opt)
            load_checkpoint(cfg.ckpt_path, self.model)
        if self.group is not None:
            put_replicated(self.model, make_mesh())
        self._local_train_indices = pinned_subset(
            np.arange(len(self.train_ds)), self._pi, self._pc)

        self.logger = MetricsLogger(cfg.log_dir if self._pi == 0 else None)
        self.timer = StepTimer()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def _train_step(self, images: torch.Tensor, labels: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """One update on a batch of crops (this rank's rows of the global
        batch in a data group); returns the CTC-mean loss."""
        cm = self.charmap
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with data_group(self.group):
            scores = self.model(images)
            loss = ctc_loss_mean(scores, labels, lengths, pad_id=cm.pad_id)
            loss.backward()
            sum_gradients(list(self.model.parameters()))
            scrub_nonfinite(self.model.parameters())
            self.optimizer.step()
            return reported(loss)

    @torch.no_grad()
    def _eval_step(self, images: torch.Tensor, labels: torch.Tensor,
                   lengths: torch.Tensor, mask: torch.Tensor):
        """`mask` excludes padding rows (tail batches are padded to the
        batch size so every val sample is scored). Returns the masked loss,
        the exact-match count, the CER sum and the decodes; in a data group
        the loss, count and sum are global, the decodes this rank's."""
        cm = self.charmap
        self.model.eval()
        with data_group(self.group):
            scores = self.model(images)
            loss = ctc_loss_mean(scores, labels, lengths, pad_id=cm.pad_id,
                                 sample_mask=mask)
            dec, dec_len = greedy_decode(scores, pad_id=cm.pad_id)
            crt, cer_sum, _ = compare_labels_device(
                dec[:, : cm.max_len], dec_len.clamp(max=cm.max_len),
                labels, lengths, mask)
            if self.group is not None:
                crt, cer_sum = global_count(torch.stack([
                    crt.float(), cer_sum.float()]))
            return reported(loss), crt, cer_sum, dec, dec_len

    # ------------------------------------------------------------------
    def _noise(self, images: np.ndarray) -> np.ndarray:
        """Host-side gaussian jitter (the OCR must see the same noisy image
        the model trains on, so noise is applied before the black-box call),
        from the numpy generator: bit for bit the JAX package's.
        Semantics parity with `AddGaussianNoice` (`transform_helper.py:33-45`).
        """
        return host_jitter(self._np_rng, images, self.cfg.std,
                           self.cfg.random_std)

    def _labels_for(self, batch: WordBatch, images: np.ndarray):
        """OCR-on-noisy labels when an OCR is configured, else GT."""
        if self.ocr is None:
            return batch.labels, batch.lengths
        res = self.ocr.query(images)
        return res.labels, res.lengths

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        best_val_acc, best_val_epoch = 0.0, 0
        for epoch in range(cfg.start_epoch + 1, cfg.epochs):
            set_learning_rate(
                self.optimizer,
                step_lr(cfg.lr, epoch, cfg.decay_step, cfg.decay))
            training_loss, steps = 0.0, 0
            for batch in batch_iterator(
                    self.train_ds, self._bl,
                    partial(collate_words, charmap=self.charmap),
                    seed=cfg.random_seed, epoch=epoch,
                    indices=self._local_train_indices,
                    num_workers=default_num_workers(), prefetch=2):
                with self.timer.time("noise"):
                    noisy = self._noise(batch.images)
                with self.timer.time("ocr"):
                    labels, lengths = self._labels_for(batch, noisy)
                with self.timer.time("device_step"):
                    loss = self._train_step(
                        self._dev(noisy), self._dev(labels),
                        self._dev(lengths))
                training_loss += float(loss)
                steps += 1

            val_loss, crt, cer_sum, n_val = self._validate()
            val_acc = crt / max(1, n_val)
            metrics = {
                "Epoch": epoch + 1,
                "train_loss": training_loss / max(1, steps),
                "val_loss": val_loss,
                "CRNN_accuracy": val_acc,
                "CRNN_CER": cer_sum / max(1, n_val),
                "lr": step_lr(cfg.lr, epoch, cfg.decay_step, cfg.decay),
            }
            if self.ocr:
                # the global ledger: each rank queried its own crops only
                metrics["Total Black-Box Calls"] = int(
                    process_sum([self.ocr.total_calls])[0])
            self.logger.log(metrics)

            if val_acc > best_val_acc:
                best_val_acc, best_val_epoch = val_acc, epoch
                self._save(epoch, val_acc)
            if epoch + 1 == cfg.epochs:
                self._save(epoch, val_acc)
        return best_val_acc, best_val_epoch

    def _validate(self):
        """Score EVERY val sample: tail batches are padded to the batch size
        and masked (the same deliberate deviation as the JAX package: the
        reference's val loader drops the tail yet divides by the full set
        size, `train_crnn.py:162-199`). Over several ranks each global
        window of B crops is split into per-rank slices; an empty slice
        feeds a blank batch so the ranks step in lockstep, and the metrics
        are global sums (the same on every rank)."""
        B = self.cfg.batch_size
        agg = dict(loss=0.0, crt=0.0, cer=0.0)
        n = 0
        collate = partial(collate_words, charmap=self.charmap)
        if self._pc == 1:
            for batch in batch_iterator(self.val_ds, B, collate,
                                        shuffle=False, drop_last=False):
                real = batch.images.shape[0]
                batch = pad_wordbatch(batch, B)
                mask = np.arange(B) < real
                n += self._validate_batch(batch, mask, agg)
        else:
            Bl = self._bl
            template = None
            for start in range(0, len(self.val_ds), B):
                window = np.arange(start, min(start + B, len(self.val_ds)))
                local_idx = window[self._pi * Bl:(self._pi + 1) * Bl]
                samples = [self.val_ds[int(i)] for i in local_idx]
                if samples:
                    batch = pad_wordbatch(collate(samples), Bl)
                    template = batch
                else:
                    if template is None:
                        template = pad_wordbatch(
                            collate([self.val_ds[0]]), Bl)
                    batch = blank_wordbatch(template, Bl)
                mask = np.arange(Bl) < len(samples)
                n += self._validate_batch(batch, mask, agg)
        return agg["loss"] / max(1, n), agg["crt"], agg["cer"], n

    def _validate_batch(self, batch, mask, agg) -> int:
        """Score one (local) batch into `agg`; returns the global
        real-sample count. The OCR (when configured) sees only this rank's
        real rows, keeping the black-box query count exact."""
        real = int(mask.sum())
        B = len(mask)
        labels, lengths = batch.labels, batch.lengths
        if self.ocr is not None:
            width = labels.shape[1]
            ocr_labels = np.zeros((B, width), np.int32)
            ocr_lengths = np.zeros((B,), np.int32)
            if real:
                res = self.ocr.query(batch.images[:real])
                w = min(width, res.labels.shape[1])
                ocr_labels[:real, :w] = res.labels[:, :w]
                ocr_lengths[:real] = np.minimum(res.lengths, width)
            labels, lengths = ocr_labels, ocr_lengths
        loss, crt, cer_sum, _, _ = self._eval_step(
            self._dev(batch.images), self._dev(labels), self._dev(lengths),
            self._dev(mask))
        if self.group is not None:
            real = int(process_sum([real])[0])
        # masked-mean loss x real recovers the per-sample sum so padded
        # tail windows carry proportional weight in the epoch average
        agg["loss"] += float(loss) * real
        agg["crt"] += float(crt)
        agg["cer"] += float(cer_sum)
        return real

    def _save(self, epoch: int, acc: float):
        """`{crnn_model_path}_{epoch}_{acc}`: the state_dict, and beside it
        `.optim` with Adam's state."""
        if self._pi != 0:
            return      # the state is the same on every rank: rank 0 writes
        path = f"{self.cfg.crnn_model_path}_{epoch}_{acc * 100:.2f}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(path, self.model, self.optimizer)
