"""The core of the two budget-aware trainers: `TrainNNPrep` on document
strips (`train/patch_trainer.py`) and `TrainNNPrepArea` on word crops
(`train/area_trainer.py`) run one two-phase algorithm over the rows of a
CER table, a strip or a crop each.

`BudgetConfig` holds the fields that both configs declare alike.
`BudgetTrainer` holds what both trainers do the same way:

  * the run's set-up: device, charmap, experiment directories, the seeded
    generators, the OCR engine, the grad UNet (library route) and the
    proxy with their `adam_l2` optimizers and warm starts;
  * the budget state: the label history, the attention weight model, the
    CER seed and the CER / entropy tables, the selection bookkeeping and
    the global bitmap;
  * selection over (R, S) row ids and a validity mask (the area trainer's
    batch is one row of B crops), and the epoch's global bitmap;
  * phase A's host targets, from the OCR's reads of the selected rows;
  * validation over per-rank windows, scored three ways (proxy against
    ground truth, OCR against ground truth, proxy against OCR) with
    global sums;
  * the epoch's side JSONs, checkpoints, best model and optuna report.

A subclass brings its datasets and batches, its step functions, how it
gets the OCR's reads, one epoch of training and the epoch's metrics.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from qea_ocr_tpu_torch.data.pipeline import (
    batch_iterator, default_num_workers)
from qea_ocr_tpu_torch.models.attention import HistoryAttention
from qea_ocr_tpu_torch.models.proxy import build_proxy
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.transforms import host_jitter
from qea_ocr_tpu_torch.parallel.multihost import process_sum, rank_device
from qea_ocr_tpu_torch.parallel.tp import (
    optimizer_state_whole, state_dict_whole)
from qea_ocr_tpu_torch.selection import (
    GLOBAL_METHODS, is_global, membership_mask, select_batch)
from qea_ocr_tpu_torch.tracking import (
    LabelHistory, attention_weights, decaying_weights, levenshtein_weights,
    weightgenerator_factory)
from qea_ocr_tpu_torch.train.state import (
    adam_l2, ema_update, parameters_swapped, set_learning_rate)
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import (
    ExpDirs, load_checkpoint, load_json, save_checkpoint, save_image_png,
    save_json)
from qea_ocr_tpu_torch.utils.metrics import MetricsLogger

# validation's global sums, in the order of `_score`'s comparisons
SCORES = ("crnn_crt", "crnn_cer", "ocr_crt", "ocr_cer", "match_crt",
          "match_cer")


@dataclasses.dataclass
class BudgetConfig:
    # the reference's flags that both trainers take
    lr_crnn: float = 1e-4
    lr_prep: float = 5e-5
    scalar: float = 1.0                    # secondary-loss scalar
    epochs: int = 25
    random_seed: int = 42
    std: int = 5
    inner_limit: int = 2
    inner_limit_skip: bool = False
    crnn_model: Optional[str] = None       # checkpoint to load
    prep_model: Optional[str] = None
    exp_base_path: str = "."
    ocr: str = "Tesseract"
    random_std: bool = True
    minibatch_subset: Optional[str] = None
    minibatch_subset_prop: float = 0.5
    start_epoch: int = 0
    data_base_path: str = "."
    warmup_epochs: int = 0
    train_subset_size: Optional[int] = None
    val_subset_size: Optional[int] = None
    cers_ocr_path: Optional[str] = None
    discount_factor: float = 1.0
    update_CRNN: bool = False
    window_size: int = 1
    query_dim: int = 32
    emb_dim: int = 256
    attn_activation: str = "sigmoid"
    weightgen_method: str = "decaying"
    decay_factor: float = 0.7
    prep_pretrain_epochs: int = 0  # identity/denoise pretraining of the UNet
                                   # before the budget loop (skipped when a
                                   # --prep_model checkpoint is loaded)
    prep_pretrain_lr: float = 1e-3 # pretraining uses its own (higher) rate
    data_parallel: bool = False  # shard the batch over the ranks of the
                                 # process group (the trainers' docstrings)
    prep_ema: float = 0.0  # >0: keep an exponential moving average of the
                           # prep parameters (decay = this value, updated
                           # after every phase-B step) and use it for
                           # validation and checkpoints. Seeded after
                           # pretraining and warm start, so it never blends
                           # untrained parameters.
    corruption: Optional[dict] = None
    lstm_hidden: int = 256
    unet_features: int = 32
    use_wandb: bool = False
    optuna_trial: object = None
    # the port's additions
    proxy: str = "crnn"    # models/proxy.py: crnn or svtr-l
    device: str = "cuda"   # torch device; a missing GPU is an error


class BudgetTrainer:
    """The two-phase trainers' shared part (module docstring)."""

    group = None                # the data group the steps reduce over
    _rank, _world = 0, 1        # global rank and world size
    _pi, _pc = 0, 1             # data index and data-axis size
    _sharded = False            # parameters and moments stored sharded
    ema_params: Optional[List[torch.Tensor]] = None   # train()

    # ------------------------------------------------------------ set-up
    def _start(self, cfg: BudgetConfig) -> None:
        """The run's set-up before its data: device, charmap, directories
        and the seeded generators."""
        self.cfg = cfg
        self.device = resolve_device(rank_device(cfg.device))
        self.charmap = CharMap.default()
        self.dirs = ExpDirs(cfg.exp_base_path).create()
        np.random.seed(cfg.random_seed)
        self._np_rng = np.random.default_rng(cfg.random_seed)
        self._gen = torch.Generator().manual_seed(cfg.random_seed)

    def _build_models(self, weight_decay: float,
                      sharded: bool = False) -> None:
        """The OCR engine; the grad UNet, pinned to the library route, and
        the proxy from the seeds `random_seed * 3 + (0, 1)`; their
        optimizers; the model-only warm starts (fresh optimizers, the
        reference's `torch.load`)."""
        cfg = self.cfg
        backend = get_ocr_helper(cfg.ocr)
        if backend is None:
            raise ValueError(f"unknown OCR backend {cfg.ocr!r}")
        self.ocr = OcrQueryEngine(backend, self.charmap)
        seed = cfg.random_seed * 3
        self.prep_model = UNet(
            init_features=cfg.unet_features, conv_impl="xla",
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.crnn_model = build_proxy(
            cfg.proxy, self.charmap.vocab_size, lstm_hidden=cfg.lstm_hidden,
            generator=torch.Generator().manual_seed(seed + 1)).to(self.device)
        self._sharded = sharded
        self.prep_optimizer = adam_l2(self.prep_model.parameters(),
                                      cfg.lr_prep, weight_decay,
                                      sharded=sharded)
        self.crnn_optimizer = adam_l2(self.crnn_model.parameters(),
                                      cfg.lr_crnn, weight_decay,
                                      sharded=sharded)
        if cfg.prep_model:
            load_checkpoint(cfg.prep_model, self.prep_model)
        if cfg.crnn_model:
            load_checkpoint(cfg.crnn_model, self.crnn_model)

    def _budget_state(self, n_rows: int, name_to_id: Dict[str, int],
                      id_to_name: Dict[int, str]) -> None:
        """The label history and weight model over `n_rows` rows, the CER
        and entropy tables (the CER seeded from `cers_ocr_path`), the
        selection bookkeeping and the metrics logger (rank 0's)."""
        cfg = self.cfg
        self._id_to_name = id_to_name
        self.weightgen_method = weightgenerator_factory(cfg.weightgen_method)
        self.history = LabelHistory(n_rows, cfg.window_size, self.charmap)
        self.attn_model = None
        if cfg.weightgen_method == "self_attention":
            self.attn_model = HistoryAttention(
                char_vocab_size=self.charmap.vocab_size,
                emb_size=cfg.emb_dim, query_dim=cfg.query_dim,
                window_size=cfg.window_size, activation=cfg.attn_activation,
                generator=torch.Generator().manual_seed(
                    cfg.random_seed * 3 + 2),
            ).to(self.device).eval()
        cers0 = np.ones((n_rows,), np.float32)
        self.selected_samples: Dict[str, List[bool]] = {}
        if cfg.cers_ocr_path:
            for name, cer in load_json(cfg.cers_ocr_path).items():
                if name in name_to_id:
                    cers0[name_to_id[name]] = cer
                self.selected_samples[name] = [False] * cfg.epochs
        # the steps update both tables in place
        self.cer_table = torch.from_numpy(cers0).to(self.device)
        self.ent_table = torch.ones((n_rows,), dtype=torch.float32,
                                    device=self.device)
        self.all_cers: Dict[str, List[float]] = {}
        self.global_bitmap = np.zeros((n_rows,), bool)
        self.logger = MetricsLogger(
            cfg.exp_base_path if self._rank == 0 else None,
            use_wandb=cfg.use_wandb and self._rank == 0)

    # ------------------------------------------------------------ helpers
    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """This rank's rows (a batch-dimension array) on its device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _eval_prep(self):
        """The prep as validation and checkpoints see it: with the EMA
        parameters in place of the raw ones when the EMA is on (the
        deployable artifact). The swap is in place, so a twin sees it."""
        if self.ema_params is None:
            return contextlib.nullcontext()
        return parameters_swapped(self.prep_model, self.ema_params)

    def _ema_step(self) -> None:
        """After a phase-B step, the EMA of the prep's parameters moves."""
        if self.ema_params is not None:
            ema_update(self.ema_params, self.prep_model.parameters(),
                       self.cfg.prep_ema)

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

    @property
    def _n_jitter(self) -> int:
        """Jittered OCR rounds a step: the inner loop less its clean read."""
        cfg = self.cfg
        return max(0, cfg.inner_limit - (1 if cfg.inner_limit_skip else 0)) \
            if cfg.inner_limit else 0

    def _maybe_optuna(self, accuracy, epoch):
        trial = self.cfg.optuna_trial
        if trial is None:
            return
        trial.report(accuracy, epoch)
        if trial.should_prune():
            try:
                import optuna
                raise optuna.TrialPruned()
            except ImportError:
                raise RuntimeError("optuna trial pruned")

    # ------------------------------------------------------------ budget
    def _select(self, ids: np.ndarray, valid: np.ndarray,
                epoch: int) -> np.ndarray:
        """The rows that query the OCR this step: (R, S) bool numpy over
        the (R, S) row `ids` whose `valid` entries are real. Every valid
        row in a warm-up epoch or without a selection method."""
        cfg = self.cfg
        if (not cfg.minibatch_subset) or epoch < cfg.warmup_epochs:
            return np.asarray(valid)
        valid = self._dev(valid)
        ids = self._dev(ids)
        if is_global(cfg.minibatch_subset):
            m = membership_mask(ids, self._dev(self.global_bitmap)) & valid
            return m.cpu().numpy()
        est_table = (self.ent_table
                     if cfg.minibatch_subset == "uniformEntropy"
                     else self.cer_table)
        bb_mask, _ = select_batch(
            cfg.minibatch_subset, None, est_table[ids.long()], valid,
            cfg.minibatch_subset_prop,
            noise=self._selection_noise(ids.shape))
        return bb_mask.cpu().numpy()

    def _refresh_global_bitmap(self, epoch: int) -> None:
        """The epoch's bitmap of a global method over the CER table. The
        table is the same on every rank (every rank writes every rank's
        rows), and so is the stream: the same bitmap."""
        cfg = self.cfg
        cers = self.cer_table.cpu().numpy()
        num = max(1, int(round((1 - cfg.minibatch_subset_prop) * len(cers))))
        # a stream of its own per epoch (not self._np_rng, whose state
        # depends on data-dependent noise draws)
        rng = np.random.default_rng((cfg.random_seed, 9173, epoch))
        self.global_bitmap = GLOBAL_METHODS[cfg.minibatch_subset](
            rng, cers, num)

    def _mark_selected(self, names, epoch: int) -> None:
        for name in names:
            self.selected_samples.setdefault(
                name, [False] * self.cfg.epochs)[epoch] = True

    def _record_cers(self, names, cers: np.ndarray) -> None:
        for name, cer in zip(names, cers):
            self.all_cers.setdefault(name, []).append(float(cer))

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

    def _phase_a_targets(self, shape, sel_rows: np.ndarray,
                         sel_ids: np.ndarray, clean, jitter) -> tuple:
        """Phase A's targets over the step's rows (`shape` is that of the
        cleaned rows, (N, 1, h, w)), on the device: (hist_labels,
        hist_lengths, hist_valid, loss_weights, jitter_images,
        jitter_labels, jitter_lengths). `clean` is the OCR's read of the
        selected rows with `inner_limit_skip`, which goes into the label
        history after the weights are drawn from it; `jitter` holds a
        (noisy images, read) pair for each jittered round."""
        cfg = self.cfg
        n, W, L = shape[0], cfg.window_size, self.charmap.max_len
        pad = self.charmap.pad_id
        hist_labels = np.full((n, W, L), pad, np.int32)
        hist_lengths = np.zeros((n, W), np.int32)
        hist_valid = np.zeros((n, W), bool)
        decaying = cfg.weightgen_method == "decaying"
        if cfg.inner_limit_skip and len(sel_rows):
            lw = self._gen_weights(sel_ids)     # pre-update history
            if decaying:
                loss_weights = lw
            else:
                loss_weights = torch.zeros((n, W + 1), device=self.device)
                loss_weights[self._dev(sel_rows)] = lw
            self.history.add(sel_ids, clean.labels, clean.lengths,
                             clean.texts)
            labs, lens, valid = self.history.gather(sel_ids)
            hist_labels[sel_rows] = labs
            hist_lengths[sel_rows] = lens
            hist_valid[sel_rows] = valid
        elif decaying or not cfg.inner_limit_skip:
            loss_weights = decaying_weights(cfg.decay_factor, W, self.device)
        else:
            # no selected row under a per-sample weight generator (e.g. a
            # global bitmap missing all of the batch): the tracking loss
            # is fully masked, and the weights keep their (n, W+1) shape
            loss_weights = torch.zeros((n, W + 1), device=self.device)
        n_jitter = self._n_jitter
        jitter_images = np.ones((n_jitter, *shape), np.float32)
        jitter_labels = np.full((n_jitter, n, L), pad, np.int32)
        jitter_lengths = np.zeros((n_jitter, n), np.int32)
        for i, (noisy, res) in enumerate(jitter):
            jitter_images[i, sel_rows] = noisy
            jitter_labels[i, sel_rows] = res.labels
            jitter_lengths[i, sel_rows] = res.lengths
        return (self._dev(hist_labels), self._dev(hist_lengths),
                self._dev(hist_valid), loss_weights,
                self._dev(jitter_images), self._dev(jitter_labels),
                self._dev(jitter_lengths))

    # ------------------------------------------------------------ training
    def train(self):
        """Pretraining (unless a prep checkpoint was loaded), the EMA's
        seed, then the budget loop. Returns (best validation OCR accuracy,
        its epoch)."""
        cfg = self.cfg
        if cfg.prep_pretrain_epochs and not cfg.prep_model:
            self._prep_pretrain()
        if cfg.prep_ema > 0.0:
            # seeded after pretraining, so the average never blends the
            # untrained parameters (pretraining bypasses the EMA)
            self.ema_params = [p.detach().clone()
                               for p in self.prep_model.parameters()]
        self._totals = collections.Counter()   # the run's ledger
        best = [0.0, 0]
        for epoch in range(cfg.start_epoch, cfg.epochs):
            if is_global(cfg.minibatch_subset):
                self._refresh_global_bitmap(epoch)
            self.ocr.reset_epoch()
            self._end_epoch(epoch, self._epoch(epoch), best)
        print("Training Completed.")
        return tuple(best)

    def _prep_pretrain(self):
        """Identity/denoise pretraining epochs for the UNet, at their own
        learning rate."""
        cfg = self.cfg
        set_learning_rate(self.prep_optimizer, cfg.prep_pretrain_lr)
        for epoch in range(cfg.prep_pretrain_epochs):
            total, n = 0.0, 0
            for batch in self._train_batches(cfg.random_seed + 7000, epoch,
                                             self._local_train_indices):
                loss = self.steps.prep_pretrain_step(self._dev(batch.images))
                total += float(loss)
                n += 1
            print(f"[prep-pretrain] epoch {epoch} mse {total / max(1, n):.5f}")
        set_learning_rate(self.prep_optimizer, cfg.lr_prep)

    def _epoch_calls(self, epoch: int) -> int:
        """After an epoch's training: its side JSONs, and its train-only
        query count summed over the ranks (validation queries the engine
        too, and the reference's "Black-Box Calls" are train-only,
        `train_nn_patch.py:298-299,411`, `train_nn_area.py:257-267`)."""
        if self.cfg.minibatch_subset:
            self._save_side_jsons(epoch)
        calls = self.ocr.epoch_calls
        if self._world > 1:
            # each rank queried its own rows
            calls = int(process_sum([calls])[0])
        return calls

    def _save_image(self, images, epoch: int) -> bool:
        """Rank 0 writes the first of the last cleaned batch."""
        if images is None or self._rank != 0:
            return False
        save_image_png(images[0].float().cpu().numpy(),
                       os.path.join(self.dirs.img_out, f"out_{epoch}.png"))
        return True

    def _write_checkpoint(self, name: str, model, optimizer) -> None:
        """Rank 0 writes `model` and `optimizer`; with sharded parameters
        every rank first takes part in gathering the shards whole, so the
        checkpoint is the single-process one."""
        if self._sharded:
            model = state_dict_whole(model)
            optimizer = optimizer_state_whole(optimizer)
        if self._rank == 0:
            save_checkpoint(os.path.join(self.dirs.ckpts, name), model,
                            optimizer)

    def _end_epoch(self, epoch: int, ocr_acc: float, best: list) -> None:
        """The epoch's checkpoints (the prep as validation saw it), the
        best model and summary (`best` is [accuracy, epoch], updated in
        place), and the optuna report. Validation's metrics are global
        sums, so the names and the best-model condition agree on every
        rank."""
        with self._eval_prep():
            self._write_checkpoint(f"Prep_model_{epoch}_{ocr_acc * 100:.2f}",
                                   self.prep_model, self.prep_optimizer)
            if ocr_acc > best[0]:
                self._write_checkpoint("Prep_model_best", self.prep_model,
                                       self.prep_optimizer)
        self._write_checkpoint(f"CRNN_model_{epoch}", self.crnn_model,
                               self.crnn_optimizer)
        if ocr_acc > best[0]:
            best[:] = ocr_acc, epoch
            self.logger.update_summary({"best_val_acc": ocr_acc,
                                        "best_val_epoch": epoch})
        self._maybe_optuna(ocr_acc * 100, epoch)

    def _save_side_jsons(self, epoch: int):
        # side-state is the rank's own (rows are pinned to ranks): over
        # several ranks each writes its shard, suffixed .pN
        sfx = f".p{self._rank}" if self._world > 1 else ""

        def path(dirname, name):
            base, ext = os.path.splitext(name)
            return os.path.join(dirname, base + sfx + ext)

        for name in (f"tracked_labels_{epoch}.json",
                     "tracked_labels_current.json"):
            self.history.save_json(path(self.dirs.tracked_labels, name),
                                   self._id_to_name)
        save_json(self.selected_samples,
                  path(self.dirs.selected_samples,
                       "selected_samples_current.json"))
        save_json(self.all_cers, path(self.dirs.cers, "all_cers.json"))

    # ------------------------------------------------------------ validation
    def _val_windows(self, dataset, size: int, collate, pad, blank):
        """(batch, its real rows) over the validation set in windows of
        `size` samples, each batch padded to this rank's share of a window
        (`pad`), so that every sample is scored (the reference iterates
        them all). Over several ranks each window is split into per-rank
        slices, as training batches are; a rank whose slice is empty feeds
        a `blank` batch, so the ranks step in lockstep."""
        local = size // self._pc
        if self._pc == 1:
            for batch in batch_iterator(
                    dataset, size, collate, shuffle=False, drop_last=False,
                    num_workers=default_num_workers(), prefetch=2):
                yield pad(batch, size), batch.images.shape[0]
            return
        template = None
        for start in range(0, len(dataset), size):
            window = np.arange(start, min(start + size, len(dataset)))
            samples = [dataset[int(i)] for i in
                       window[self._pi * local:(self._pi + 1) * local]]
            if samples:
                template = pad(collate(samples), local)
                yield template, len(samples)
            else:
                if template is None:
                    template = pad(collate([dataset[0]]), local)
                yield blank(template, local), 0

    def _val_scores(self, acc_count: str, cer_count: str) -> dict:
        """Every validation batch (`_val_batches`) scored into global sums
        (`_validate_batch`), with the prep as checkpoints see it: the
        accuracies over the count `acc_count`, the CERs and the loss over
        `cer_count`, and the two counts."""
        agg = dict.fromkeys(SCORES + ("loss", acc_count, cer_count), 0.0)
        with self._eval_prep():
            for batch, real in self._val_batches():
                self._validate_batch(batch, real, agg)
        counts = {k: int(agg[k]) for k in (acc_count, cer_count)}
        acc_n, cer_n = max(1, counts[acc_count]), max(1, counts[cer_count])
        return dict(
            crnn_acc=agg["crnn_crt"] / acc_n, ocr_acc=agg["ocr_crt"] / acc_n,
            match_acc=agg["match_crt"] / acc_n,
            crnn_cer=agg["crnn_cer"] / cer_n, ocr_cer=agg["ocr_cer"] / cer_n,
            match_cer=agg["match_cer"] / cer_n,
            loss=agg["loss"] / cer_n, **counts)

    def _score(self, agg: dict, loss, mask, dec, dec_len, ocr_labels,
               ocr_lengths, gt, gt_len, **counts) -> None:
        """Add one batch's scores to `agg`: the proxy's decode against the
        ground truth, the OCR's read against the ground truth, and the
        proxy against the OCR, over the `mask`ed rows, then the named
        `counts`. Over several ranks the sums are global. The batch loss
        is a mean over its real rows, the first count: times that count it
        adds their sum."""
        L = self.charmap.max_len
        dec, dec_len = dec[:, :L], dec_len.clamp(max=L)
        sums = []
        for pair in ((dec, dec_len, gt, gt_len),
                     (ocr_labels, ocr_lengths, gt, gt_len),
                     (dec, dec_len, ocr_labels, ocr_lengths)):
            sums += compare_labels_device(*pair, mask)[:2]
        sums = torch.stack([x.float() for x in (*sums, *counts.values())])
        if self.group is not None:
            dist.all_reduce(sums, group=self.group)
        sums = sums.tolist()
        for key, value in zip(SCORES + tuple(counts), sums):
            agg[key] += value
        agg["loss"] += float(loss) * sums[len(SCORES)]
