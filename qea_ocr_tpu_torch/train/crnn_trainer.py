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

Not ported yet: `data_parallel` and multi-process validation (ROADMAP.md
Queue 1 item 7) raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Iterable, Optional

import numpy as np
import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import ImgDataset, SyntheticWordDataset
from qea_ocr_tpu_torch.data.pipeline import (
    WordBatch, batch_iterator, collate_words, default_num_workers,
    pad_wordbatch)
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.transforms import host_jitter
from qea_ocr_tpu_torch.train.state import adam_l2, set_learning_rate, step_lr
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
    data_parallel: bool = False  # not ported yet (ROADMAP Queue 1 item 7)
    # the port's addition
    device: str = "cuda"   # torch device; a missing GPU is an error


@torch.no_grad()
def scrub_nonfinite(params: Iterable[torch.nn.Parameter]) -> None:
    """Zero every non-finite entry of each parameter's `.grad`, in place
    (parity with the reference's NaN hook)."""
    for p in params:
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)


class TrainCRNN:
    def __init__(self, cfg: CrnnTrainerConfig):
        if cfg.data_parallel:
            raise NotImplementedError(
                "data_parallel is not ported to qea_ocr_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 7)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
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
        self.model = CRNN(
            self.charmap.vocab_size, lstm_hidden=cfg.lstm_hidden,
            generator=torch.Generator().manual_seed(cfg.random_seed)
        ).to(self.device)
        self.optimizer = adam_l2(self.model.parameters(), cfg.lr,
                                 weight_decay=0.0)
        if cfg.ckpt_path:
            # parameters and batch statistics with a fresh optimizer, as the
            # JAX package restores (`load_checkpoint` there without
            # restore_opt)
            load_checkpoint(cfg.ckpt_path, self.model)

        self.logger = MetricsLogger(cfg.log_dir)
        self.timer = StepTimer()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def _train_step(self, images: torch.Tensor, labels: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """One update on a batch of crops; returns the CTC-mean loss."""
        cm = self.charmap
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        scores = self.model(images)
        loss = ctc_loss_mean(scores, labels, lengths, pad_id=cm.pad_id)
        loss.backward()
        scrub_nonfinite(self.model.parameters())
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self, images: torch.Tensor, labels: torch.Tensor,
                   lengths: torch.Tensor, mask: torch.Tensor):
        """`mask` excludes padding rows (tail batches are padded to the
        batch size so every val sample is scored). Returns the masked loss,
        the exact-match count, the CER sum and the decodes."""
        cm = self.charmap
        self.model.eval()
        scores = self.model(images)
        loss = ctc_loss_mean(scores, labels, lengths, pad_id=cm.pad_id,
                             sample_mask=mask)
        dec, dec_len = greedy_decode(scores, pad_id=cm.pad_id)
        crt, cer_sum, _ = compare_labels_device(
            dec[:, : cm.max_len], dec_len.clamp(max=cm.max_len),
            labels, lengths, mask)
        return loss, crt, cer_sum, dec, dec_len

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
                    self.train_ds, cfg.batch_size,
                    partial(collate_words, charmap=self.charmap),
                    seed=cfg.random_seed, epoch=epoch,
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
                metrics["Total Black-Box Calls"] = self.ocr.total_calls
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
        size, `train_crnn.py:162-199`)."""
        B = self.cfg.batch_size
        agg = dict(loss=0.0, crt=0.0, cer=0.0)
        n = 0
        for batch in batch_iterator(
                self.val_ds, B,
                partial(collate_words, charmap=self.charmap),
                shuffle=False, drop_last=False):
            real = batch.images.shape[0]
            batch = pad_wordbatch(batch, B)
            mask = np.arange(B) < real
            n += self._validate_batch(batch, mask, agg)
        return agg["loss"] / max(1, n), agg["crt"], agg["cer"], n

    def _validate_batch(self, batch, mask, agg) -> int:
        """Score one batch into `agg`; returns its real-sample count. The
        OCR (when configured) sees only the real rows, keeping the
        black-box query count exact."""
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
        # masked-mean loss x real recovers the per-sample sum so padded
        # tail windows carry proportional weight in the epoch average
        agg["loss"] += float(loss) * real
        agg["crt"] += float(crt)
        agg["cer"] += float(cer_sum)
        return real

    def _save(self, epoch: int, acc: float):
        """`{crnn_model_path}_{epoch}_{acc}`: the state_dict, and beside it
        `.optim` with Adam's state."""
        path = f"{self.cfg.crnn_model_path}_{epoch}_{acc * 100:.2f}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(path, self.model, self.optimizer)
