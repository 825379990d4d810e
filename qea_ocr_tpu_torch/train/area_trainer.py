"""Budget-aware textarea (word-crop) preprocessor trainer (counterpart of
`qea_ocr_tpu/train/area_trainer.py`, reference `train_nn_area.py:30-413`).

The same two-phase algorithm as the patch trainer, but the dataset yields
batches of pre-cropped word images (default 64), the UNet runs directly on
(B, 1, 32, 128) crops, selection operates per minibatch, and an optional
cosine learning-rate schedule steps per epoch (`train_nn_area.py:156-161,
313-315`).

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

Not ported yet, each raising `NotImplementedError`: `data_parallel` and
multi-process runs (ROADMAP.md Queue 1 item 7) and `optuna_trial` (item 8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from functools import partial
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import ImgDataset, SyntheticWordDataset
from qea_ocr_tpu_torch.data.pipeline import (
    WordBatch, batch_iterator, collate_words, default_num_workers,
    pad_wordbatch)
from qea_ocr_tpu_torch.models.attention import HistoryAttention
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.ctc import ctc_loss_mean, greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import (
    cer_from_labels, compare_labels_device)
from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
from qea_ocr_tpu_torch.ops.transforms import host_jitter
from qea_ocr_tpu_torch.selection import (
    GLOBAL_METHODS, is_global, membership_mask, select_batch)
from qea_ocr_tpu_torch.tracking import (
    LabelHistory, attention_weights, decaying_weights, levenshtein_weights,
    weightgenerator_factory)
from qea_ocr_tpu_torch.train.patch_steps import (
    make_steps, model_modes, optimizer_step)
from qea_ocr_tpu_torch.train.state import (
    adam_l2, cosine_lr, ema_update, parameters_swapped, set_learning_rate)
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import (
    ExpDirs, load_checkpoint, load_json, save_checkpoint, save_image_png,
    save_json)
from qea_ocr_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass
class AreaTrainerConfig:
    # reference flag surface (area_cli.py:10-124)
    batch_size: int = 64
    lr_crnn: float = 1e-4
    lr_prep: float = 5e-5
    scalar: float = 1.0
    epochs: int = 25
    random_seed: int = 42
    std: int = 5
    inner_limit: int = 2
    inner_limit_skip: bool = False
    crnn_model: Optional[str] = None
    prep_model: Optional[str] = None
    exp_base_path: str = "."
    ocr: str = "Tesseract"
    dataset: str = "pos"                 # pos | vgg | synthetic
    random_std: bool = True
    minibatch_subset: Optional[str] = None
    minibatch_subset_prop: float = 0.5
    start_epoch: int = 0
    data_base_path: str = "."
    warmup_epochs: int = 0
    train_subset_size: Optional[int] = None
    val_subset_size: Optional[int] = None
    cers_ocr_path: Optional[str] = None
    update_CRNN: bool = False
    window_size: int = 1
    query_dim: int = 32
    emb_dim: int = 256
    attn_activation: str = "sigmoid"
    weightgen_method: str = "decaying"
    decay_factor: float = 0.7
    discount_factor: float = 1.0
    lr_scheduler: Optional[str] = None   # None | "cosine" (CRNN lr, reference)
    # cosine decay of the prep's rate too: the reference stubs it out
    # (`train_nn_area.py:161,316`); an opt-in against late-run
    # co-adaptation drift, as in the JAX package
    lr_scheduler_prep: Optional[str] = None
    data_parallel: bool = False  # not ported yet (ROADMAP Queue 1 item 7)
    prep_ema: float = 0.0     # >0: validate and checkpoint an exponential
                              # moving average of the prep parameters
                              # (decay = this value, updated after every
                              # phase-B step), seeded after pretraining
    prep_pretrain_epochs: int = 0  # identity/denoise UNet pretraining before
                                   # the budget loop (skipped when a
                                   # --prep_model checkpoint is loaded)
    prep_pretrain_lr: float = 1e-3
    synthetic_train_size: int = 128
    synthetic_val_size: int = 32
    corruption: Optional[dict] = None
    lstm_hidden: int = 256
    unet_features: int = 32
    use_wandb: bool = False
    optuna_trial: object = None            # not ported yet (item 8)
    # the port's addition
    device: str = "cuda"   # torch device; a missing GPU is an error


def make_area_steps(prep_model: nn.Module, crnn_model: nn.Module, charmap, *,
                    prep_optimizer: torch.optim.Optimizer | None = None,
                    crnn_optimizer: torch.optim.Optimizer | None = None,
                    sec_loss_scalar: float = 1.0) -> SimpleNamespace:
    """The area path's step functions over `prep_model` (UNet) and
    `crnn_model`. As in `patch_steps.make_steps`, where the JAX functions
    take and return states these update the models, their optimizers and
    the tables in place and return the remaining values in the JAX order;
    every function leaves each model's train/eval mode as it found it.
    `prep_pretrain_step` is the patch trainer's (MSE(prep(x), x))."""
    pad_id = charmap.pad_id
    max_len = charmap.max_len

    @torch.no_grad()
    def prep_forward(images):
        """The UNet's eval-mode output on (B, 1, 32, 128) crops."""
        with model_modes(frozen=(prep_model,)):
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
        with model_modes(train=(prep_model,), frozen=(crnn_model,)):
            img_out = prep_model(images)
            scores = crnn_model(img_out)
            loss = (ctc_loss_mean(scores, gt_labels, gt_lengths,
                                  pad_id=pad_id)
                    + ((img_out - 1.0) ** 2).mean() * sec_loss_scalar)
            optimizer_step(loss, *pairs)
        with torch.no_grad():
            scores = scores.detach()
            dec, dec_len = greedy_decode(scores, pad_id=pad_id)
            cers = cer_from_labels(dec[:, :max_len],
                                   dec_len.clamp(max=max_len), gt_labels,
                                   gt_lengths)
            ids = strip_ids.long()
            cer_table[ids] = cers.to(cer_table.dtype)
            ent_table[ids] = mean_sequence_entropy(scores).to(ent_table.dtype)
        return (img_out.detach(), dict(loss=loss.detach(), cers=cers),
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
        loss = loss + ((per_mse * m).sum() / m.sum().clamp(min=1.0)
                       ) * sec_loss_scalar
        dec, dec_len = greedy_decode(scores, pad_id=pad_id)
        return img_out, dec, dec_len, loss

    pretrain = make_steps(prep_model, crnn_model, charmap,
                          prep_optimizer=prep_optimizer).prep_pretrain_step
    return SimpleNamespace(prep_forward=prep_forward, phase_b=phase_b,
                           prep_pretrain_step=pretrain,
                           val_forward=val_forward)


class TrainNNPrepArea:
    """Word-crop two-phase trainer."""

    def __init__(self, cfg: AreaTrainerConfig):
        self.cfg = cfg
        for flag, item in (("data_parallel", 7), ("optuna_trial", 8)):
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"{flag} is not ported to qea_ocr_tpu_torch yet "
                    f"(ROADMAP.md Queue 1 item {item})")
        self.device = resolve_device(cfg.device)
        self.charmap = CharMap.default()
        self.dirs = ExpDirs(cfg.exp_base_path).create()
        np.random.seed(cfg.random_seed)
        self._np_rng = np.random.default_rng(cfg.random_seed)
        self._gen = torch.Generator().manual_seed(cfg.random_seed)

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

        backend = get_ocr_helper(cfg.ocr)
        if backend is None:
            raise ValueError(f"unknown OCR backend {cfg.ocr!r}")
        self.ocr = OcrQueryEngine(backend, self.charmap)

        # the UNet runs under a gradient every step: library route only
        seeds = [cfg.random_seed * 3 + i for i in range(3)]
        self.prep_model = UNet(
            init_features=cfg.unet_features, conv_impl="xla",
            generator=torch.Generator().manual_seed(seeds[0])).to(self.device)
        self.crnn_model = CRNN(
            self.charmap.vocab_size, lstm_hidden=cfg.lstm_hidden,
            generator=torch.Generator().manual_seed(seeds[1])).to(self.device)
        # weight_decay 0: parity with `train_nn_area.py:149-154`
        self.prep_optimizer = adam_l2(self.prep_model.parameters(),
                                      cfg.lr_prep, 0.0)
        self.crnn_optimizer = adam_l2(self.crnn_model.parameters(),
                                      cfg.lr_crnn, 0.0)
        if cfg.prep_model:
            load_checkpoint(cfg.prep_model, self.prep_model)
        if cfg.crnn_model:
            load_checkpoint(cfg.crnn_model, self.crnn_model)

        self.weightgen_method = weightgenerator_factory(cfg.weightgen_method)
        self.history = LabelHistory(len(self.train_ds), cfg.window_size,
                                    self.charmap)
        self.attn_model = None
        if cfg.weightgen_method == "self_attention":
            self.attn_model = HistoryAttention(
                char_vocab_size=self.charmap.vocab_size,
                emb_size=cfg.emb_dim, query_dim=cfg.query_dim,
                window_size=cfg.window_size, activation=cfg.attn_activation,
                generator=torch.Generator().manual_seed(seeds[2]),
            ).to(self.device).eval()

        n = len(self.train_ds)
        cers0 = np.ones((n,), np.float32)
        self.selected_samples: Dict[str, List[bool]] = {}
        if cfg.cers_ocr_path:
            seed = load_json(cfg.cers_ocr_path)
            for name, cer in seed.items():
                if name in self.train_ds.name_to_id:
                    cers0[self.train_ds.name_to_id[name]] = cer
                self.selected_samples[name] = [False] * cfg.epochs
        # phase B updates both tables in place
        self.cer_table = torch.from_numpy(cers0).to(self.device)
        self.ent_table = torch.ones((n,), dtype=torch.float32,
                                    device=self.device)
        self.all_cers: Dict[str, List[float]] = {}
        self.global_bitmap = np.zeros((n,), bool)

        # phase A does not care where its strips come from: the patch step's
        self._patch_steps = make_steps(
            self.prep_model, self.crnn_model, self.charmap,
            crnn_optimizer=self.crnn_optimizer, sec_loss_scalar=cfg.scalar)
        self.steps = make_area_steps(
            self.prep_model, self.crnn_model, self.charmap,
            prep_optimizer=self.prep_optimizer,
            crnn_optimizer=self.crnn_optimizer, sec_loss_scalar=cfg.scalar)
        self.logger = MetricsLogger(cfg.exp_base_path,
                                    use_wandb=cfg.use_wandb)
        self._last_crnn_loss = 0.0
        self.ema_params: Optional[List[torch.Tensor]] = None   # train()

    # ------------------------------------------------------------------
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _noise(self, images: np.ndarray) -> np.ndarray:
        """Jitter for the OCR's inner loops, from the numpy generator (bit
        for bit the JAX package's)."""
        return host_jitter(self._np_rng, images, self.cfg.std,
                           self.cfg.random_std)

    def _selection_noise(self, shape) -> torch.Tensor:
        """Uniform [0, 1) numbers for the rank functions that draw points or
        priorities (`jax.random` streams do not carry over: a comparison
        with the JAX trainer overrides this)."""
        return torch.rand(tuple(shape), generator=self._gen)

    def _gen_weights(self, sel_ids: np.ndarray) -> torch.Tensor:
        """Loss weights from the history before this step's labels."""
        cfg = self.cfg
        if cfg.weightgen_method == "decaying":
            return decaying_weights(cfg.decay_factor, cfg.window_size,
                                    self.device)
        labs, lens, valid = self.history.gather(sel_ids)
        if cfg.weightgen_method == "levenshtein":
            return levenshtein_weights(self._dev(labs), self._dev(lens),
                                       self._dev(valid))
        return attention_weights(self.attn_model, self._dev(labs),
                                 self._dev(valid))

    def _eval_prep(self):
        """The prep as validation and checkpoints see it: the EMA
        parameters in place of the raw ones when the EMA is on."""
        if self.ema_params is None:
            return contextlib.nullcontext()
        return parameters_swapped(self.prep_model, self.ema_params)

    # ------------------------------------------------------------------
    def _prep_pretrain(self):
        """Identity/denoise pretraining epochs for the UNet (the patch
        trainer's mechanism on word crops)."""
        cfg = self.cfg
        set_learning_rate(self.prep_optimizer, cfg.prep_pretrain_lr)
        for epoch in range(cfg.prep_pretrain_epochs):
            total, n = 0.0, 0
            for batch in batch_iterator(
                    self.train_ds, cfg.batch_size,
                    partial(collate_words, charmap=self.charmap),
                    seed=cfg.random_seed + 7000, epoch=epoch):
                loss = self.steps.prep_pretrain_step(self._dev(batch.images))
                total += float(loss)
                n += 1
            print(f"[prep-pretrain] epoch {epoch} mse {total / max(1, n):.5f}")
        set_learning_rate(self.prep_optimizer, cfg.lr_prep)

    def _select(self, batch: WordBatch, epoch: int) -> np.ndarray:
        """The crops that query the OCR this step: (B,) bool numpy."""
        cfg = self.cfg
        B = batch.images.shape[0]
        if (not cfg.minibatch_subset) or epoch < cfg.warmup_epochs:
            return np.ones((B,), bool)
        ids = self._dev(batch.strip_ids)
        if is_global(cfg.minibatch_subset):
            return membership_mask(
                ids, self._dev(self.global_bitmap)).cpu().numpy()
        est_table = (self.ent_table
                     if cfg.minibatch_subset == "uniformEntropy"
                     else self.cer_table)
        m, _ = select_batch(
            cfg.minibatch_subset, None, est_table[ids.long()][None],
            torch.ones((1, B), dtype=torch.bool, device=self.device),
            cfg.minibatch_subset_prop,
            noise=self._selection_noise((1, B)))
        return m[0].cpu().numpy()

    def train(self):
        cfg = self.cfg
        if cfg.prep_pretrain_epochs and not cfg.prep_model:
            self._prep_pretrain()
        if cfg.prep_ema > 0.0:
            # seeded after pretraining, so the average never blends the
            # untrained parameters (pretraining bypasses the EMA)
            self.ema_params = [p.detach().clone()
                               for p in self.prep_model.parameters()]
        B = cfg.batch_size
        L = self.charmap.max_len
        W = cfg.window_size
        n_jitter = max(0, cfg.inner_limit - (1 if cfg.inner_limit_skip else 0)) \
            if cfg.inner_limit else 0
        best_val_acc, best_val_epoch = 0.0, 0
        total_crnn_updates = 0
        total_train_bb_calls = 0

        for epoch in range(cfg.start_epoch, cfg.epochs):
            if cfg.lr_scheduler == "cosine":
                set_learning_rate(self.crnn_optimizer,
                                  cosine_lr(cfg.lr_crnn, epoch, cfg.epochs))
            if cfg.lr_scheduler_prep == "cosine":
                set_learning_rate(self.prep_optimizer,
                                  cosine_lr(cfg.lr_prep, epoch, cfg.epochs))
            if is_global(cfg.minibatch_subset):
                num = max(1, int(round((1 - cfg.minibatch_subset_prop)
                                       * len(self.train_ds))))
                # a stream of its own per epoch (not self._np_rng, whose
                # state depends on data-dependent noise draws)
                rng = np.random.default_rng((cfg.random_seed, 9173, epoch))
                self.global_bitmap = GLOBAL_METHODS[cfg.minibatch_subset](
                    rng, self.cer_table.cpu().numpy(), num)
            self.ocr.reset_epoch()
            training_loss, steps = 0.0, 0
            crnn_loss_acc = 0.0
            epoch_crnn_updates = 0
            epoch_print = True
            last_img_out = None

            for batch in batch_iterator(
                    self.train_ds, B,
                    partial(collate_words, charmap=self.charmap),
                    seed=cfg.random_seed, epoch=epoch,
                    num_workers=default_num_workers(), prefetch=2):
                images = self._dev(batch.images)
                img_preds = self.steps.prep_forward(images)
                bb_mask = self._select(batch, epoch)
                sel_rows = np.nonzero(bb_mask)[0]
                sel_ids = batch.strip_ids[sel_rows]
                if epoch_print:
                    print(f"Total Samples - {B}")
                    print(f"OCR Samples - {len(sel_rows)}")
                    epoch_print = False
                for r in sel_rows:
                    self.selected_samples.setdefault(
                        batch.names[r], [False] * cfg.epochs)[epoch] = True

                if cfg.inner_limit:
                    self._phase_a(img_preds, bb_mask, sel_rows, sel_ids,
                                  n_jitter, L, W)
                    total_crnn_updates += 1
                    epoch_crnn_updates += 1
                    crnn_loss_acc += self._last_crnn_loss

                img_out, metrics, _, _ = self.steps.phase_b(
                    images, self._dev(batch.labels), self.cer_table,
                    self.ent_table, self._dev(batch.lengths),
                    self._dev(batch.strip_ids), update_crnn=cfg.update_CRNN)
                if self.ema_params is not None:
                    ema_update(self.ema_params, self.prep_model.parameters(),
                               cfg.prep_ema)
                training_loss += float(metrics["loss"])
                steps += 1
                last_img_out = img_out
                if cfg.minibatch_subset:
                    cers_np = metrics["cers"].float().cpu().numpy()
                    for r, name in enumerate(batch.names):
                        self.all_cers.setdefault(name, []).append(
                            float(cers_np[r]))

            if cfg.minibatch_subset:
                self._save_side_jsons(epoch)

            # train-only snapshot before _validate(): the reference's area
            # ledger counts only training queries in both Black-Box counters
            # and the CRNN_loss denominator (train_nn_area.py:257-267,
            # 306-307)
            epoch_bb_calls = self.ocr.epoch_calls
            total_train_bb_calls += epoch_bb_calls
            val = self._validate()
            metrics_out = {
                "CRNN_accuracy": val["crnn_acc"],
                f"{cfg.ocr}_accuracy": val["ocr_acc"],
                "CRNN_CER": val["crnn_cer"],
                f"{cfg.ocr}_cer": val["ocr_cer"],
                "Epoch": epoch + 1,
                "train_loss": training_loss / max(1, steps),
                "val_loss": val["loss"],
                "Total Black-Box Calls": total_train_bb_calls,
                "Black-Box Calls": epoch_bb_calls,
                "Total CRNN Updates": total_crnn_updates,
                "CRNN Updates": epoch_crnn_updates,
                "CRNN_loss": crnn_loss_acc / max(1, epoch_bb_calls),
                "CRNN_OCR_Matching_ACC": val["match_acc"],
                "CRNN_OCR_Matching_CER": val["match_cer"],
            }
            self.logger.log(metrics_out)
            if last_img_out is not None:
                save_image_png(last_img_out[0].float().cpu().numpy(),
                               os.path.join(self.dirs.img_out,
                                            f"out_{epoch}.png"))
            ocr_acc = val["ocr_acc"]
            with self._eval_prep():
                save_checkpoint(os.path.join(
                    self.dirs.ckpts, f"Prep_model_{epoch}_{ocr_acc * 100:.2f}"),
                    self.prep_model, self.prep_optimizer)
                if ocr_acc > best_val_acc:
                    save_checkpoint(
                        os.path.join(self.dirs.ckpts, "Prep_model_best"),
                        self.prep_model, self.prep_optimizer)
            save_checkpoint(os.path.join(self.dirs.ckpts, f"CRNN_model_{epoch}"),
                            self.crnn_model, self.crnn_optimizer)
            if ocr_acc > best_val_acc:
                best_val_acc, best_val_epoch = ocr_acc, epoch
                self.logger.update_summary({"best_val_acc": best_val_acc,
                                            "best_val_epoch": best_val_epoch})
        print("Training Completed.")
        return best_val_acc, best_val_epoch

    # ------------------------------------------------------------------
    def _phase_a(self, img_preds, bb_mask, sel_rows, sel_ids, n_jitter, L,
                 W):
        """One CRNN (proxy) update on the cleaned crops: the history CTC
        (with `inner_limit_skip`) and `n_jitter` jittered copies, each
        labelled by the OCR."""
        cfg = self.cfg
        B = img_preds.shape[0]
        sel_imgs = img_preds[self._dev(sel_rows)].float().cpu().numpy()

        hist_labels = np.full((B, W, L), self.charmap.pad_id, np.int32)
        hist_lengths = np.zeros((B, W), np.int32)
        hist_valid = np.zeros((B, W), bool)
        if cfg.inner_limit_skip:
            res = self.ocr.query(sel_imgs)
            lw = self._gen_weights(sel_ids)     # the history before this step
            if cfg.weightgen_method == "decaying":
                loss_weights = lw
            else:
                loss_weights = torch.zeros((B, W + 1), device=self.device)
                loss_weights[self._dev(sel_rows)] = lw
            self.history.add(sel_ids, res.labels, res.lengths, res.texts)
            labs, lens, valid = self.history.gather(sel_ids)
            hist_labels[sel_rows] = labs
            hist_lengths[sel_rows] = lens
            hist_valid[sel_rows] = valid
        else:
            loss_weights = decaying_weights(cfg.decay_factor, W, self.device)

        jitter_images = np.ones((n_jitter, *img_preds.shape), np.float32)
        jitter_labels = np.full((n_jitter, B, L), self.charmap.pad_id,
                                np.int32)
        jitter_lengths = np.zeros((n_jitter, B), np.int32)
        for i in range(n_jitter):
            noisy = self._noise(sel_imgs)
            res = self.ocr.query(noisy)
            jitter_images[i, sel_rows] = noisy
            jitter_labels[i, sel_rows] = res.labels
            jitter_lengths[i, sel_rows] = res.lengths

        loss = self._patch_steps.phase_a(
            img_preds, self._dev(bb_mask), self._dev(hist_labels),
            self._dev(hist_lengths), self._dev(hist_valid), loss_weights,
            self._dev(jitter_images), self._dev(jitter_labels),
            self._dev(jitter_lengths),
            decaying=(cfg.weightgen_method == "decaying"),
            inner_limit_skip=cfg.inner_limit_skip)
        self._last_crnn_loss = float(loss)

    # ------------------------------------------------------------------
    def _validate(self):
        """Score every validation crop: the tail batch is padded to the
        batch size and masked (the JAX package's deliberate fix of the
        reference, which drops the tail yet divides by the full set size,
        `train_nn_area.py:137,347`)."""
        B = self.cfg.batch_size
        agg = dict(crnn_crt=0.0, crnn_cer=0.0, ocr_crt=0.0, ocr_cer=0.0,
                   match_crt=0.0, match_cer=0.0, loss=0.0)
        count = 0
        with self._eval_prep():
            for batch in batch_iterator(
                    self.val_ds, B,
                    partial(collate_words, charmap=self.charmap),
                    shuffle=False, drop_last=False,
                    num_workers=default_num_workers(), prefetch=2):
                real = batch.images.shape[0]
                batch = pad_wordbatch(batch, B)
                count += self._validate_batch(batch, np.arange(B) < real,
                                              agg)
        n = max(1, count)
        return dict(
            crnn_acc=agg["crnn_crt"] / n, ocr_acc=agg["ocr_crt"] / n,
            match_acc=agg["match_crt"] / n, crnn_cer=agg["crnn_cer"] / n,
            ocr_cer=agg["ocr_cer"] / n, match_cer=agg["match_cer"] / n,
            loss=agg["loss"] / n)

    def _validate_batch(self, batch: WordBatch, mask: np.ndarray,
                        agg: dict) -> int:
        """Score one validation batch into `agg`; the OCR reads its real
        rows only (the query count stays exact). Returns the real count."""
        L = self.charmap.max_len
        B = len(mask)
        real = int(mask.sum())
        mask_dev = self._dev(mask)
        gt, gt_len = self._dev(batch.labels), self._dev(batch.lengths)
        img_out, dec, dec_len, loss = self.steps.val_forward(
            self._dev(batch.images), gt, gt_len, mask_dev)
        ocr_labels = np.zeros((B, L), np.int32)
        ocr_lengths = np.zeros((B,), np.int32)
        if real:
            res = self.ocr.query(img_out[:real].float().cpu().numpy())
            ocr_labels[:real] = res.labels
            ocr_lengths[:real] = res.lengths
        ocr_labels, ocr_lengths = self._dev(ocr_labels), self._dev(ocr_lengths)
        dec_c, dec_l = dec[:, :L], dec_len.clamp(max=L)
        crt, cer, _ = compare_labels_device(dec_c, dec_l, gt, gt_len, mask_dev)
        t_crt, t_cer, _ = compare_labels_device(
            ocr_labels, ocr_lengths, gt, gt_len, mask_dev)
        m_crt, m_cer, _ = compare_labels_device(
            dec_c, dec_l, ocr_labels, ocr_lengths, mask_dev)
        agg["crnn_crt"] += float(crt); agg["crnn_cer"] += float(cer)
        agg["ocr_crt"] += float(t_crt); agg["ocr_cer"] += float(t_cer)
        agg["match_crt"] += float(m_crt); agg["match_cer"] += float(m_cer)
        # the batch loss is a masked mean over its real crops; x real
        # recovers their sum, so the padded tail carries its own weight
        agg["loss"] += float(loss) * real
        return real

    def _save_side_jsons(self, epoch: int):
        id_to_name = dict(enumerate(self.train_ds.names))
        for name in (f"tracked_labels_{epoch}.json",
                     "tracked_labels_current.json"):
            self.history.save_json(
                os.path.join(self.dirs.tracked_labels, name), id_to_name)
        save_json(self.selected_samples,
                  os.path.join(self.dirs.selected_samples,
                               "selected_samples_current.json"))
        save_json(self.all_cers, os.path.join(self.dirs.cers, "all_cers.json"))
