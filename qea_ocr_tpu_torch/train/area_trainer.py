"""Budget-aware textarea (word-crop) preprocessor trainer (counterpart of
`qea_ocr_tpu/train/area_trainer.py`, reference `train_nn_area.py:30-413`).

The same two-phase algorithm as the patch trainer, but the dataset yields
batches of pre-cropped word images (default 64), the UNet runs directly on
(B, 1, 32, 128) crops, selection operates per minibatch, and an optional
cosine learning-rate schedule steps per epoch (`train_nn_area.py:156-161,
313-315`). What the two trainers share (set-up, budget state, selection,
phase A's targets, validation scoring, checkpoints) is `train/budget.py`'s.

Phase A is the patch trainer's (`train/patch_steps.py:make_steps(...)
.phase_a`: it does not care where its strips come from); phase B is its own
(`make_area_steps`): the UNet's train-mode forward, the CRNN with frozen
batch statistics, CTC on the ground-truth labels plus `scalar` *
MSE(out, white), then the CER and entropy tables. There is no strip gather,
and the UNet stays on the library route (`conv_impl="xla"`): it runs under a
gradient every step, as in the JAX package (`area_trainer.py:246-253`). On a
CUDA device the CTC losses go through the hand-written alpha and beta
kernels: phase A's history CTC over B*W rows and each jitter copy's, phase
B's, and validation's (forward only).

Data parallelism (`data_parallel`, JAX `area_trainer.py:303-382`), one
process a GPU under a `torch.distributed` group: `batch_size` is the global
batch; each rank owns a pinned subset of the crops, loads, selects for and
OCRs only its `batch_size / world` rows a step, and the steps compute over
the global batch (global counts and batch statistics, summed gradients,
every rank's rows in the replicated tables). The query ledger is summed
over ranks, validation windows are split per rank with global metrics, rank
0 writes the metrics, images and checkpoints, each rank its own side JSONs
(`.pN`). Without a group it is a world of one.

`optuna_trial` gets each epoch's validation accuracy and may prune the run
(`sweeps/sweep.py`).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import ImgDataset, SyntheticWordDataset
from qea_ocr_tpu_torch.data.pipeline import (
    WordBatch, blank_wordbatch, batch_iterator, collate_words,
    default_num_workers, pad_wordbatch)
from qea_ocr_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import cer_from_labels
from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
from qea_ocr_tpu_torch.parallel.mesh import make_mesh, put_replicated
from qea_ocr_tpu_torch.parallel.multihost import (
    gather_rows, global_count, global_mean, in_data_group, pinned_subset,
    process_shard, process_sum, reported)
from qea_ocr_tpu_torch.train.budget import BudgetConfig, BudgetTrainer
from qea_ocr_tpu_torch.train.patch_steps import (
    make_steps, model_modes, optimizer_step)
from qea_ocr_tpu_torch.train.state import cosine_lr, set_learning_rate
from qea_ocr_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class AreaTrainerConfig(BudgetConfig):
    # reference flag surface (area_cli.py:10-124), beyond BudgetConfig's
    batch_size: int = 64
    dataset: str = "pos"                 # pos | vgg | synthetic
    lr_scheduler: Optional[str] = None   # None | "cosine" (CRNN lr, reference)
    # cosine decay of the prep's rate too: the reference stubs it out
    # (`train_nn_area.py:161,316`); an opt-in against late-run
    # co-adaptation drift, as in the JAX package
    lr_scheduler_prep: Optional[str] = None
    synthetic_train_size: int = 128
    synthetic_val_size: int = 32


def make_area_steps(prep_model: nn.Module, crnn_model: nn.Module, charmap, *,
                    prep_optimizer: torch.optim.Optimizer | None = None,
                    crnn_optimizer: torch.optim.Optimizer | None = None,
                    sec_loss_scalar: float = 1.0,
                    group=None) -> SimpleNamespace:
    """The area path's step functions over `prep_model` (UNet) and
    `crnn_model`. As in `patch_steps.make_steps`, where the JAX functions
    take and return states these update the models, their optimizers and
    the tables in place and return the remaining values in the JAX order;
    every function leaves each model's train/eval mode as it found it.
    `prep_pretrain_step` is the patch trainer's (MSE(prep(x), x)). With a
    process `group` each function is one step over the global batch of the
    group's ranks, as there: global counts and batch statistics, summed
    gradients, every rank's rows in the tables, global losses returned."""
    pad_id = charmap.pad_id
    max_len = charmap.max_len

    @torch.no_grad()
    def prep_forward(images):
        """The UNet's eval-mode output on (B, 1, 32, 128) crops."""
        with span("prep_forward"), model_modes(frozen=(prep_model,)):
            return prep_model(images)

    def phase_b(images, gt_labels, cer_table, ent_table, gt_lengths,
                strip_ids, *, update_crnn: bool):
        """UNet update (and the CRNN's when `update_crnn`) on CTC(GT) +
        sec_loss_scalar * MSE(out, white), the UNet in train mode (its
        batch statistics move) and the CRNN's batch statistics frozen; then
        each crop's CER and entropy written into the tables at `strip_ids`.
        Returns (img_out, dict(loss, cers), cer_table, ent_table)."""
        if prep_optimizer is None or (update_crnn and crnn_optimizer is None):
            raise ValueError("phase_b updates the prep (and with update_crnn "
                             "the crnn): give make_area_steps their "
                             "optimizers")
        pairs = [(prep_optimizer, prep_model)]
        if update_crnn:
            pairs.append((crnn_optimizer, crnn_model))
        with span("phase_b"):
            with model_modes(train=(prep_model,), frozen=(crnn_model,)):
                img_out = prep_model(images)
                scores = crnn_model(img_out)
                with span("loss"):
                    loss = (ctc_loss_mean(scores, gt_labels, gt_lengths,
                                          pad_id=pad_id)
                            + global_mean((img_out - 1.0) ** 2)
                            * sec_loss_scalar)
                optimizer_step(loss, *pairs)
            with span("tables"), torch.no_grad():
                scores = scores.detach()
                dec, dec_len = greedy_decode(scores, pad_id=pad_id)
                cers = cer_from_labels(dec[:, :max_len],
                                       dec_len.clamp(max=max_len), gt_labels,
                                       gt_lengths)
                # every rank writes every rank's rows
                ids = gather_rows(strip_ids.long())
                cer_table[ids] = gather_rows(cers).to(cer_table.dtype)
                ent_table[ids] = gather_rows(
                    mean_sequence_entropy(scores)).to(ent_table.dtype)
        return (img_out.detach(), dict(loss=reported(loss), cers=cers),
                cer_table, ent_table)

    @torch.no_grad()
    def val_forward(images, gt_labels, gt_lengths, sample_mask):
        """Validation forward: (img_out, decoded (B, T), decoded lengths
        (B,), loss). `sample_mask` excludes `pad_wordbatch` padding rows from
        both terms of the loss, so a padded tail batch scores its real
        crops only."""
        with model_modes(frozen=(prep_model, crnn_model)):
            img_out = prep_model(images)
            scores = crnn_model(img_out)
        loss = ctc_loss_mean(scores, gt_labels, gt_lengths, pad_id=pad_id,
                             sample_mask=sample_mask)
        m = sample_mask.float()
        per_mse = ((img_out - 1.0) ** 2).mean(dim=(1, 2, 3))
        loss = loss + ((per_mse * m).sum()
                       / global_count(m.sum()).clamp(min=1.0)
                       ) * sec_loss_scalar
        dec, dec_len = greedy_decode(scores, pad_id=pad_id)
        return img_out, dec, dec_len, reported(loss)

    pretrain = make_steps(prep_model, crnn_model, charmap,
                          prep_optimizer=prep_optimizer,
                          group=group).prep_pretrain_step
    return SimpleNamespace(prep_forward=prep_forward, phase_b=in_data_group(group, phase_b),
                           prep_pretrain_step=pretrain,
                           val_forward=in_data_group(group, val_forward))


class TrainNNPrepArea(BudgetTrainer):
    """Word-crop two-phase trainer."""

    def __init__(self, cfg: AreaTrainerConfig):
        # ----------------------------------------------------- topology
        if cfg.data_parallel:
            self._rank, self._world = self._pi, self._pc = process_shard()
            if dist.is_initialized():
                self.group = dist.group.WORLD
            if cfg.batch_size % self._pc:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must be a multiple of the "
                    f"device count {self._pc} for data_parallel mode")
        self._bl = cfg.batch_size // self._pc     # local crops a step
        self._start(cfg)
        self._collate = partial(collate_words, charmap=self.charmap)

        if cfg.dataset == "synthetic":
            self.train_ds = SyntheticWordDataset(
                cfg.synthetic_train_size, seed=cfg.random_seed,
                corruption=cfg.corruption)
            self.val_ds = SyntheticWordDataset(
                cfg.synthetic_val_size, seed=cfg.random_seed + 1,
                corruption=cfg.corruption)
        else:
            split = {"pos": (C.POS_TEXT_TRAIN, C.POS_TEXT_DEV),
                     "vgg": (C.VGG_TEXT_TRAIN, C.VGG_TEXT_DEV)}[cfg.dataset]
            self.train_ds = ImgDataset(
                os.path.join(cfg.data_base_path, split[0]),
                num_subset=cfg.train_subset_size)
            self.val_ds = ImgDataset(
                os.path.join(cfg.data_base_path, split[1]),
                num_subset=cfg.val_subset_size)

        # the UNet runs under a gradient every step: library route only;
        # weight_decay 0: parity with `train_nn_area.py:149-154`
        self._build_models(0.0)
        if self.group is not None:
            mesh = make_mesh()
            for obj in (self.prep_model, self.crnn_model):
                put_replicated(obj, mesh)
        self._local_train_indices = pinned_subset(
            np.arange(len(self.train_ds)), self._pi, self._pc)
        self._budget_state(len(self.train_ds), self.train_ds.name_to_id,
                           dict(enumerate(self.train_ds.names)))

        # phase A does not care where its strips come from: the patch step's
        self._patch_steps = make_steps(
            self.prep_model, self.crnn_model, self.charmap,
            crnn_optimizer=self.crnn_optimizer, sec_loss_scalar=cfg.scalar,
            group=self.group)
        self.steps = make_area_steps(
            self.prep_model, self.crnn_model, self.charmap,
            prep_optimizer=self.prep_optimizer,
            crnn_optimizer=self.crnn_optimizer, sec_loss_scalar=cfg.scalar,
            group=self.group)

    def _train_batches(self, seed: int, epoch: int, indices, **kw):
        return batch_iterator(self.train_ds, self._bl, self._collate,
                              seed=seed, epoch=epoch, indices=indices, **kw)

    # ------------------------------------------------------------------
    def _epoch(self, epoch: int) -> float:
        """One epoch's training, validation and metrics; returns the
        validation OCR accuracy."""
        cfg = self.cfg
        if cfg.lr_scheduler == "cosine":
            set_learning_rate(self.crnn_optimizer,
                              cosine_lr(cfg.lr_crnn, epoch, cfg.epochs))
        if cfg.lr_scheduler_prep == "cosine":
            set_learning_rate(self.prep_optimizer,
                              cosine_lr(cfg.lr_prep, epoch, cfg.epochs))
        training_loss, steps = 0.0, 0
        crnn_loss_acc = 0.0
        epoch_crnn_updates = 0
        epoch_print = True
        last_img_out = None

        for batch in self._train_batches(
                cfg.random_seed, epoch, self._local_train_indices,
                num_workers=default_num_workers(), prefetch=2):
            images = self._dev(batch.images)
            img_preds = self.steps.prep_forward(images)
            B = len(batch.strip_ids)
            # the batch is one row of B crops for the selection
            bb_mask = self._select(batch.strip_ids[None],
                                   np.ones((1, B), bool), epoch)[0]
            sel_rows = np.nonzero(bb_mask)[0]
            sel_ids = batch.strip_ids[sel_rows]
            if epoch_print:
                # global-bitmap methods select different counts per
                # rank: the sum of the ranks' counts
                n_sel = int(process_sum([len(sel_rows)])[0]) \
                    if self.group is not None else len(sel_rows)
                print(f"Total Samples - {cfg.batch_size}")
                print(f"OCR Samples - {n_sel}")
                epoch_print = False
            self._mark_selected([batch.names[r] for r in sel_rows], epoch)

            if cfg.inner_limit:
                crnn_loss_acc += self._phase_a(img_preds, bb_mask, sel_rows,
                                               sel_ids)
                epoch_crnn_updates += 1

            img_out, metrics, _, _ = self.steps.phase_b(
                images, self._dev(batch.labels), self.cer_table,
                self.ent_table, self._dev(batch.lengths),
                self._dev(batch.strip_ids), update_crnn=cfg.update_CRNN)
            self._ema_step()
            training_loss += float(metrics["loss"])
            steps += 1
            last_img_out = img_out
            if cfg.minibatch_subset:
                self._record_cers(batch.names,
                                  metrics["cers"].float().cpu().numpy())

        ledger = self._totals
        ledger["crnn_updates"] += epoch_crnn_updates
        epoch_bb_calls = self._epoch_calls(epoch)
        ledger["train_calls"] += epoch_bb_calls
        val = self._validate()
        self.logger.log({
            "CRNN_accuracy": val["crnn_acc"],
            f"{cfg.ocr}_accuracy": val["ocr_acc"],
            "CRNN_CER": val["crnn_cer"],
            f"{cfg.ocr}_cer": val["ocr_cer"],
            "Epoch": epoch + 1,
            "train_loss": training_loss / max(1, steps),
            "val_loss": val["loss"],
            "Total Black-Box Calls": ledger["train_calls"],
            "Black-Box Calls": epoch_bb_calls,
            "Total CRNN Updates": ledger["crnn_updates"],
            "CRNN Updates": epoch_crnn_updates,
            "CRNN_loss": crnn_loss_acc / max(1, epoch_bb_calls),
            "CRNN_OCR_Matching_ACC": val["match_acc"],
            "CRNN_OCR_Matching_CER": val["match_cer"],
        })
        self._save_image(last_img_out, epoch)
        return val["ocr_acc"]

    # ------------------------------------------------------------------
    def _phase_a(self, img_preds, bb_mask, sel_rows, sel_ids) -> float:
        """One CRNN (proxy) update on the cleaned crops: the history CTC
        (with `inner_limit_skip`) and the jittered copies, each labelled
        by a synchronous OCR query. Returns the loss."""
        cfg = self.cfg
        sel_imgs = img_preds[self._dev(sel_rows)].float().cpu().numpy()
        clean = self.ocr.query(sel_imgs) if cfg.inner_limit_skip else None
        jitter = []
        for _ in range(self._n_jitter):
            noisy = self._noise(sel_imgs)
            jitter.append((noisy, self.ocr.query(noisy)))
        loss = self._patch_steps.phase_a(
            img_preds, self._dev(bb_mask),
            *self._phase_a_targets(img_preds.shape, sel_rows, sel_ids,
                                   clean, jitter),
            decaying=(cfg.weightgen_method == "decaying"),
            inner_limit_skip=cfg.inner_limit_skip)
        return float(loss)

    # ------------------------------------------------------------------
    def _validate(self):
        """Global validation metrics, every rate over the real crops: the
        tail batch is padded to the batch size and masked (the JAX
        package's deliberate fix of the reference, which drops the tail
        yet divides by the full set size, `train_nn_area.py:137,347`)."""
        return self._val_scores("crops", "crops")

    def _val_batches(self):
        return self._val_windows(self.val_ds, self.cfg.batch_size,
                                 self._collate, pad_wordbatch,
                                 blank_wordbatch)

    def _validate_batch(self, batch: WordBatch, real: int, agg: dict):
        """Score one validation batch into `agg` (`_score`); the OCR reads
        its real rows only (the query count stays exact)."""
        L = self.charmap.max_len
        B = batch.images.shape[0]
        mask_dev = self._dev(np.arange(B) < real)
        gt, gt_len = self._dev(batch.labels), self._dev(batch.lengths)
        img_out, dec, dec_len, loss = self.steps.val_forward(
            self._dev(batch.images), gt, gt_len, mask_dev)
        ocr_labels = np.zeros((B, L), np.int32)
        ocr_lengths = np.zeros((B,), np.int32)
        if real:
            res = self.ocr.query(img_out[:real].float().cpu().numpy())
            ocr_labels[:real] = res.labels
            ocr_lengths[:real] = res.lengths
        self._score(agg, loss, mask_dev, dec, dec_len, self._dev(ocr_labels),
                    self._dev(ocr_lengths), gt, gt_len,
                    crops=mask_dev.sum())
