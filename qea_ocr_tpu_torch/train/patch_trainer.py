"""Budget-aware patch preprocessor trainer, the flagship entry point
(counterpart of `qea_ocr_tpu/train/patch_trainer.py`, reference
`train_nn_patch.py:34-467`).

  * documents are batched (`batch_docs` >= 1; the reference hardwires batch
    size 1) and every per-strip loop is a fixed-shape masked device op;
  * CER bookkeeping, greedy decode and entropy estimates run inside the
    phase steps (`qea_ocr_tpu_torch.train.patch_steps`), selection on the
    batch's table rows on the device;
  * the black-box OCR is the only host boundary, behind the async
    `OcrQueryEngine`;
  * checkpoints are reference-schema state_dicts (`utils/io.py`) plus the
    reference's JSON side-state (tracked labels, CER history, the
    selected-samples bitmap);
  * what it shares with the area trainer (set-up, budget state, selection,
    phase A's targets, validation scoring, checkpoints) is
    `train/budget.py`'s.

Two-phase step:
  PHASE A (proxy): OCR the budget-selected cleaned strips; weighted CTC over
    the label history (weights generated from the history *before* this
    step's labels are added, the reference's order
    `train_nn_patch.py:282-283`) plus jittered-OCR CTC inner loops; one CRNN
    optimizer step per batch.
  PHASE B (prep): CTC(GT) through the strip gather with frozen CRNN batch
    statistics + `scalar` * MSE(doc, white); one UNet optimizer step
    (the CRNN's too with `update_CRNN`); the CER table is refreshed from the
    CRNN's decode against the ground truth.

Two UNets stand over one set of parameters: the grad model, always on the
library route (`conv_impl="xla"`), and a no-grad twin built with
`conv_impl="auto"` that `QEA_CONV_IMPL=cmajor` sends through the
hand-written channel-major conv kernel. The twin serves `prep_extract` and
`val_forward` only.

Parallelism (JAX `patch_trainer.py:308-423`), one process a GPU under a
`torch.distributed` group (`parallel.multihost.maybe_init_distributed`):

  * `data_parallel`: `batch_docs` is the global batch. Each rank owns a
    pinned subset of the documents, loads, selects for and OCRs only its
    `batch_docs / world` documents a step, and the steps compute over the
    global batch (`make_steps(group=...)`: global counts and batch
    statistics, summed gradients, every rank's rows in the replicated
    tables). The query ledger is summed over ranks; validation splits
    each window of `batch_docs` documents the same way (an empty slice
    feeds a blank batch) and its metrics are global sums. Rank 0 writes
    the metrics, images and checkpoints; each rank its own side JSONs
    (`.pN`). Without a group it is a world of one.
  * `tensor_parallel=T`: a (world / T) x T mesh (`parallel.tp`); the data
    shard follows the data index (rank // T), parameters and Adam moments
    are stored sharded over the T ranks of a model group, and only the
    first of them queries the OCR, broadcasting the labels to the others:
    the ledger is that of `T = 0`. Checkpoints are gathered whole.

`pruning_artifact` (a JSON of `pruning/prune.py`) restricts training to the
artifact's documents, ahead of `train_subset_size`; `optuna_trial` gets each
epoch's validation accuracy and may prune the run (`sweeps/sweep.py`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch.distributed as dist

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import PatchDocuments
from qea_ocr_tpu_torch.data.pipeline import (
    DocBatch, batch_iterator, blank_docbatch, collate_docs,
    default_num_workers, pad_docbatch)
from qea_ocr_tpu_torch.parallel.mesh import (
    DATA_AXIS, make_mesh, put_replicated)
from qea_ocr_tpu_torch.parallel.multihost import (
    broadcast_object, pinned_subset, process_shard, process_sum)
from qea_ocr_tpu_torch.parallel.tp import MODEL_AXIS, make_mesh_2d, put_tp
from qea_ocr_tpu_torch.train.budget import BudgetConfig, BudgetTrainer
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import set_learning_rate
from qea_ocr_tpu_torch.utils.io import (
    load_checkpoint, resolve_side_shard, save_image_png)
from qea_ocr_tpu_torch.utils.metrics import StepTimer, maybe_profile


@dataclasses.dataclass
class PatchTrainerConfig(BudgetConfig):
    # reference flag surface (patch_cli.py:10-156), beyond BudgetConfig's
    exp_name: str = "test_patch"
    weight_decay: float = 5e-4
    image_prop: Optional[float] = None
    pruning_artifact: Optional[str] = None
    optim_crnn_path: Optional[str] = None  # full-state resume (parameters and
    optim_prep_path: Optional[str] = None  # Adam moments), --optim_*_path
    tracked_labels_path: Optional[str] = None  # resume label history (JSON)
    profile_dir: Optional[str] = None          # torch.profiler trace output
    async_ocr: bool = True    # pipeline the host OCR of batch k+1 over the
                              # device work of batch k (strips one prep
                              # update stale relative to the synchronous
                              # reference; identical budget accounting).
                              # False restores reference-exact synchronous
                              # querying.
    tensor_parallel: int = 0     # T > 0: parameters and moments sharded
                                 # over model groups of T ranks
    micro_steps: int = 1  # G > 1: split each batch into G sequential chunks
                          # inside the step, one phase-A and one phase-B
                          # update per chunk: the reference's small-batch
                          # optimizer dynamics with one selection and one OCR
                          # round per batch. Must divide batch_docs.
    micro_refresh: bool = False  # re-extract phase A's history strips from
                          # the current prep inside each micro-chunk
    batch_docs: int = 1
    max_strips: int = 32
    dataset: str = "patch"                 # patch | synthetic
    synthetic_train_docs: int = 32
    synthetic_val_docs: int = 8
    synthetic_strips_per_doc: int = 6
    doc_size: tuple = C.DOC_SIZE


class TrainNNPrep(BudgetTrainer):
    """Patch-dataset two-phase trainer."""

    def __init__(self, cfg: PatchTrainerConfig):
        self._start(cfg)

        # ----------------------------------------------------------- data
        if cfg.dataset == "synthetic":
            kw = dict(n_strips=cfg.synthetic_strips_per_doc,
                      max_strips=cfg.max_strips, corruption=cfg.corruption,
                      doc_size=cfg.doc_size)
            self.dataset = PatchDocuments.synthetic(
                cfg.synthetic_train_docs, seed=cfg.random_seed, **kw)
            self.validation_set = PatchDocuments.synthetic(
                cfg.synthetic_val_docs, seed=cfg.random_seed + 1, **kw)
        else:
            self.dataset = PatchDocuments(
                os.path.join(cfg.data_base_path, C.PATCH_TRAIN),
                max_strips=cfg.max_strips, num_subset=cfg.train_subset_size,
                doc_size=cfg.doc_size)
            self.validation_set = PatchDocuments(
                os.path.join(cfg.data_base_path, C.PATCH_DEV),
                max_strips=cfg.max_strips, num_subset=cfg.val_subset_size,
                doc_size=cfg.doc_size)

        self.train_indices = self._training_indices()
        self.train_set_size = len(self.train_indices)

        # ----------------------------------------------------------- models
        # The grad model is pinned to the library route; the twin over the
        # same tensors resolves `auto` (QEA_CONV_IMPL), so an opt-in to the
        # channel-major kernel reroutes the no-grad forwards only. It is
        # made once the grad model is on its device. Checkpoints are the
        # same for every conv_impl.
        self._build_models(cfg.weight_decay,
                           sharded=bool(cfg.tensor_parallel))
        if cfg.optim_prep_path:
            # explicit full-state resume (reference --optim_prep_path); the
            # configured learning rate wins over the stored one
            load_checkpoint(cfg.optim_prep_path, self.prep_model,
                            self.prep_optimizer)
            set_learning_rate(self.prep_optimizer, cfg.lr_prep)
        if cfg.optim_crnn_path:
            load_checkpoint(cfg.optim_crnn_path, self.crnn_model,
                            self.crnn_optimizer)
            set_learning_rate(self.crnn_optimizer, cfg.lr_crnn)
        self._place_models()
        self._dl = cfg.batch_docs // self._pc      # this rank's documents
        # made once the grad model is placed: it holds the same tensors
        self.prep_eval_model = self.prep_model.twin("auto")

        # ------------------------------------------ tracking and side state
        self._budget_state(self.dataset.num_strips, self.dataset.name_to_id,
                           self.dataset.id_to_name)
        if cfg.tracked_labels_path:
            # multi-process runs shard side-state per rank (.pN suffix,
            # _save_side_jsons); resume prefers this rank's shard, so one
            # flag value serves every rank
            self.history.load_json(
                resolve_side_shard(cfg.tracked_labels_path, self._rank),
                self.dataset.name_to_id)

        self.steps = make_steps(
            self.prep_model, self.crnn_model, self.charmap,
            prep_optimizer=self.prep_optimizer,
            crnn_optimizer=self.crnn_optimizer,
            sec_loss_scalar=cfg.scalar,
            prep_eval_model=self.prep_eval_model, group=self.group)

        if cfg.micro_steps > 1:
            if cfg.batch_docs % cfg.micro_steps:
                raise ValueError(f"micro_steps={cfg.micro_steps} must divide "
                                 f"batch_docs={cfg.batch_docs}")
            # each rank splits its own rows: micro-step g takes chunk g of
            # every rank, so the chunk must divide over the data axis
            chunk = cfg.batch_docs // cfg.micro_steps
            if chunk % self._pc:
                raise ValueError(
                    f"micro-step chunk size {chunk} (batch_docs "
                    f"{cfg.batch_docs} / micro_steps {cfg.micro_steps}) "
                    f"must be a multiple of the data-axis size {self._pc}")
        self._local_train_indices = pinned_subset(
            self.train_indices, self._pi, self._pc)
        if self._pc > 1:
            # lockstep trim: every rank owns the same count; the ledger
            # denominators use the effective global size
            self.train_set_size = len(self._local_train_indices) * self._pc

        self.timer = StepTimer()
        # (phase-B loss, phase-A loss) of every step, as the host read them
        self.step_losses: list = []

    # ------------------------------------------------------------------
    def _place_models(self):
        """The topology of the run and the models' placement on it.

        Single-process (neither flag, or no process group under
        `data_parallel`) nothing moves. Under `data_parallel` every rank
        takes rank 0's models and optimizer states; under `tensor_parallel`
        the same, and then parameters and moments are sharded over the
        model axis (`parallel.tp.put_tp`)."""
        cfg = self.cfg
        tp = cfg.tensor_parallel
        self._model_group = None    # tensor parallel: one OCR a model group
        self._queries_ocr = True
        if not (cfg.data_parallel or tp):
            return
        if tp and not dist.is_initialized():
            raise ValueError(
                "tensor_parallel needs a process group: run under torchrun "
                "or with QEA_DISTRIBUTED=1")
        self._rank, world = process_shard()
        self._world = world
        if tp:
            if world % tp:
                raise ValueError(f"tensor_parallel={tp} must divide the "
                                 f"process count {world}")
            n_data = world // tp
            if cfg.batch_docs % n_data:
                raise ValueError(
                    f"batch_docs={cfg.batch_docs} must be a multiple of the "
                    f"data-axis size {n_data} (= {world} processes / tp "
                    f"{tp})")
            mesh = make_mesh_2d(n_data, tp)
            self.group = mesh.get_group(DATA_AXIS)
            self._model_group = mesh.get_group(MODEL_AXIS)
            self._pi, self._pc = mesh.get_local_rank(DATA_AXIS), n_data
            self._queries_ocr = mesh.get_local_rank(MODEL_AXIS) == 0
            axes = (DATA_AXIS, MODEL_AXIS)
        else:
            if cfg.batch_docs % world:
                raise ValueError(
                    f"batch_docs={cfg.batch_docs} must be a multiple of the "
                    f"device count {world} for data_parallel mode")
            if not dist.is_initialized():
                return
            mesh = make_mesh()
            self.group = dist.group.WORLD
            self._pi, self._pc = self._rank, world
            axes = (DATA_AXIS,)
        for axis in axes:
            for obj in (self.prep_model, self.crnn_model,
                        self.prep_optimizer, self.crnn_optimizer):
                put_replicated(obj, mesh, axis)
        if tp:
            put_tp(self.prep_model, mesh, self.prep_optimizer)
            put_tp(self.crnn_model, mesh, self.crnn_optimizer)

    def _ask(self, images: np.ndarray, wait: bool):
        """Send `images` to the OCR: a result with `wait`, else a future.
        Under tensor parallelism only the first rank of a model group asks
        (the others hold the same images); `_resolve` shares the labels."""
        if not self._queries_ocr:
            return None
        return self.ocr.query(images) if wait else self.ocr.submit(images)

    def _resolve(self, res_or_future):
        """The OCR's result of an `_ask`, on every rank of a model group."""
        res = (res_or_future.result()
               if hasattr(res_or_future, "result") else res_or_future)
        if self._model_group is not None:
            res = broadcast_object(res, self._model_group)
        return res

    def _wait(self, res_or_future):
        with self.timer.time("ocr_wait"):
            return self._resolve(res_or_future)

    # ------------------------------------------------------------------
    def _training_indices(self) -> np.ndarray:
        cfg = self.cfg
        idx = np.arange(len(self.dataset))
        if cfg.pruning_artifact:
            from qea_ocr_tpu_torch.pruning.prune import pruning_indices
            idx = pruning_indices(self.dataset, cfg.pruning_artifact)
        elif cfg.train_subset_size:
            rng = np.random.default_rng(cfg.random_seed)
            idx = rng.permutation(idx)[: cfg.train_subset_size]
        return idx

    def _train_batches(self, seed: int, epoch: int, indices, **kw):
        return batch_iterator(self.dataset, self._dl, collate_docs,
                              seed=seed, epoch=epoch, indices=indices, **kw)

    # ------------------------------------------------------------------
    def train(self):
        with maybe_profile(self.cfg.profile_dir):
            return super().train()

    def _epoch(self, epoch: int) -> float:
        """One epoch's training, validation and metrics; returns the
        validation OCR accuracy."""
        cfg = self.cfg
        indices = self._local_train_indices
        if cfg.image_prop:
            # a per-rank subsample of the pinned subset: the global
            # proportion holds, and so does lockstep (equal subsets)
            k = int(cfg.image_prop * len(indices))
            indices = self._np_rng.permutation(indices)[:k]
        epoch_t0 = time.perf_counter()
        epoch_print = True
        totals = dict(loss=0.0, crnn_loss=0.0, crnn_updates=0, steps=0,
                      doc_out=None, batch=None)

        def account(stats):
            totals["loss"] += stats["loss"]
            totals["crnn_loss"] += stats["crnn_loss"]
            totals["crnn_updates"] += stats["crnn_updates"]
            totals["steps"] += 1
            totals["doc_out"], totals["batch"] = (stats["doc_out"],
                                                  stats["batch"])

        pending = None
        for batch in self._train_batches(
                cfg.random_seed, epoch, indices,
                num_workers=default_num_workers(), prefetch=2):
            work = self._prepare_work(batch, epoch, epoch_print)
            epoch_print = False
            if not cfg.async_ocr:
                account(self._process_work(work))
            else:
                # one-deep pipeline: the device works on batch k while
                # the host OCRs batch k+1 (submitted in _prepare_work)
                if pending is not None:
                    account(self._process_work(pending))
                pending = work
        if pending is not None:
            account(self._process_work(pending))
        ledger = self._totals
        ledger["crnn_updates"] += totals["crnn_updates"]

        epoch_bb_calls = self._epoch_calls(epoch)
        print(f"Epoch BB calls - {epoch_bb_calls}")
        val = self._validate()
        ledger["train_calls"] += epoch_bb_calls
        ledger["train_val_calls"] += epoch_bb_calls + val["bb_calls"]
        # a batch's phase-B loss is a mean over its D documents; x D
        # recovers the per-document sum, and the reference divides by
        # the full train set size (`train_nn_patch.py:350`)
        train_loss = (totals["loss"] * cfg.batch_docs
                      / max(1, self.train_set_size))
        crnn_train_loss = totals["crnn_loss"] / max(1, epoch_bb_calls)

        metrics_out = {
            "CRNN_accuracy": val["crnn_acc"],
            f"{cfg.ocr}_accuracy": val["ocr_acc"],
            "CRNN_CER": val["crnn_cer"],
            f"{cfg.ocr}_cer": val["ocr_cer"],
            "Epoch": epoch + 1,
            "train_loss": train_loss,
            "val_loss": val["loss"],
            "Total Black-Box Calls": ledger["train_calls"],
            "Black-Box Calls": epoch_bb_calls,
            "Train + Val BB Calls": epoch_bb_calls + val["bb_calls"],
            "Total Train + Val BB Calls": ledger["train_val_calls"],
            "Total CRNN Updates": ledger["crnn_updates"],
            "CRNN Updates": totals["crnn_updates"],
            "CRNN_loss": crnn_train_loss,
            "CRNN_OCR_Matching_ACC": val["match_acc"],
            "CRNN_OCR_Matching_CER": val["match_cer"],
        }
        metrics_out.update(self.timer.summary())
        # host clock over the epoch's training, side JSONs and
        # validation (the checkpoint writes after it are not in it)
        metrics_out["time/epoch_s"] = time.perf_counter() - epoch_t0
        self.logger.log(metrics_out)
        # sample cleaned image (+ original once), by rank 0
        if self._save_image(totals["doc_out"], epoch) and epoch == 0:
            save_image_png(totals["batch"].images[0],
                           os.path.join(self.dirs.img_out, "out_original.png"))
        return val["ocr_acc"]

    # ------------------------------------------------------------------
    def _prepare_work(self, batch: DocBatch, epoch: int,
                      epoch_print: bool) -> dict:
        """Extract strips with the current prep, select the query budget,
        and send the selected strips to the black-box OCR (a synchronous
        query, or an asynchronous submit with `async_ocr`). The host-side
        noise is drawn here, so the OCR and phase A see the same jittered
        images."""
        cfg = self.cfg
        images = self._dev(batch.images)
        bboxes = self._dev(batch.bboxes)
        with self.timer.time("prep_extract"):
            _, strips = self.steps.prep_extract(images, bboxes)
        bb_mask = self._select(batch.strip_ids, batch.strip_mask,
                               epoch)                     # (D, S) bool
        n = bb_mask.size                                  # strip rows
        flat_bb = bb_mask.reshape(n)
        sel_rows = np.nonzero(flat_bb)[0]
        sel_ids = batch.strip_ids.reshape(n)[sel_rows]
        if epoch_print:
            print(f"Total Samples - {int(batch.strip_mask.sum())}")
            print(f"OCR Samples - {len(sel_rows)}")
        self._mark_selected(
            [names[j] for names, row in zip(batch.strip_names, bb_mask)
             for j in np.nonzero(row)[0] if j < len(names)], epoch)

        work = dict(batch=batch, images=images, bboxes=bboxes, strips=strips,
                    flat_bb=flat_bb, sel_rows=sel_rows, sel_ids=sel_ids,
                    clean=None, jitter=[])
        if cfg.inner_limit and len(sel_rows):
            # gather on the device, fetch only the selected strips
            sel_strips = strips[self._dev(sel_rows)].float().cpu().numpy()
            wait = not cfg.async_ocr
            if cfg.inner_limit_skip:
                with self.timer.time("ocr_issue"):
                    work["clean"] = self._ask(sel_strips, wait)
            for _ in range(self._n_jitter):
                noisy = self._noise(sel_strips)
                with self.timer.time("ocr_issue"):
                    work["jitter"].append((noisy, self._ask(noisy, wait)))
        return work

    def _process_work(self, work: dict) -> dict:
        """Phase A (consuming the OCR results) and phase B for one prepared
        batch."""
        cfg = self.cfg
        batch: DocBatch = work["batch"]
        strips = work["strips"]
        sel_rows = work["sel_rows"]
        crnn_loss = 0.0
        crnn_updates = 0
        doc_args = (work["images"], work["bboxes"],
                    self._dev(batch.strip_mask), self._dev(batch.gt_labels),
                    self.cer_table, self.ent_table,
                    self._dev(batch.gt_lengths), self._dev(batch.strip_ids))

        if cfg.inner_limit:
            # asked for a clean read when any strip was selected (under
            # tensor parallelism only one rank of a model group holds it)
            clean = (self._wait(work["clean"])
                     if cfg.inner_limit_skip and len(sel_rows) else None)
            jitter = [(noisy, self._wait(pending))
                      for noisy, pending in work["jitter"]]
            targets = self._phase_a_targets(strips.shape, sel_rows,
                                            work["sel_ids"], clean, jitter)
            with self.timer.time("phase_ab"):
                doc_out, metrics, _, _, loss = self.steps.phase_ab(
                    *doc_args, strips, self._dev(work["flat_bb"]), *targets,
                    decaying=(cfg.weightgen_method == "decaying"),
                    inner_limit_skip=cfg.inner_limit_skip,
                    update_crnn=cfg.update_CRNN,
                    micro_steps=cfg.micro_steps,
                    micro_refresh=cfg.micro_refresh)
                crnn_loss = float(loss)
            crnn_updates = max(1, cfg.micro_steps)
        else:
            with self.timer.time("phase_b"):
                doc_out, metrics, _, _ = self.steps.phase_b(
                    *doc_args, update_crnn=cfg.update_CRNN,
                    micro_steps=cfg.micro_steps)
        self._ema_step()

        if cfg.minibatch_subset:
            mask = batch.strip_mask
            cers_np = metrics["cers"].float().cpu().numpy().reshape(
                mask.shape)
            self._record_cers(
                [names[j] for names, row in zip(batch.strip_names, mask)
                 for j in np.nonzero(row)[0]], cers_np[mask])

        loss_b = float(metrics["loss"])
        self.step_losses.append((loss_b, crnn_loss))
        return dict(loss=loss_b, crnn_loss=crnn_loss,
                    crnn_updates=crnn_updates, doc_out=doc_out, batch=batch)

    # ------------------------------------------------------------------
    def _validate(self):
        """Global validation metrics: accuracies over the valid strips,
        CERs and the loss over the real documents (the reference's
        /val_set_size, `train_nn_patch.py:396`), and the queries it
        took."""
        calls_before = self.ocr.total_calls
        val = self._val_scores("strips", "docs")
        print(f"Validation Dataset Calls - {val['strips']}")
        val["bb_calls"] = int(process_sum(
            [self.ocr.total_calls - calls_before])[0])
        return val

    def _val_batches(self):
        """This rank's validation batches, all of `batch_docs / data-axis
        size` documents (`_val_windows`): padded documents are mask-zero,
        so every document is scored (`train_nn_patch.py:366-398`)."""
        return self._val_windows(self.validation_set, self.cfg.batch_docs,
                                 collate_docs, pad_docbatch, blank_docbatch)

    def _validate_batch(self, batch: DocBatch, real: int, agg: dict):
        """Score one validation batch into `agg` (`_score`); the OCR reads
        the cleaned valid strips (costed: the train + val ledger). Padding
        documents have no valid strip, so `real` is not needed."""
        L = self.charmap.max_len
        n = batch.strip_mask.size          # strip rows
        dev_mask = self._dev(batch.strip_mask)
        doc_out, strips, dec, dec_len, loss = self.steps.val_forward(
            self._dev(batch.images), self._dev(batch.bboxes), dev_mask,
            self._dev(batch.gt_labels), self._dev(batch.gt_lengths))
        flat_mask = dev_mask.reshape(n)
        rows = np.nonzero(batch.strip_mask.reshape(n))[0]
        ocr_labels = np.full((n, L), self.charmap.pad_id, np.int32)
        ocr_lengths = np.zeros((n,), np.int32)
        if len(rows):
            res = self._resolve(self._ask(
                strips[self._dev(rows)].float().cpu().numpy(), wait=True))
            ocr_labels[rows] = res.labels
            ocr_lengths[rows] = res.lengths
        # padded documents have no valid strip; every real one has at least
        # one (the dataset injects a dummy ' ')
        self._score(agg, loss, flat_mask, dec, dec_len,
                    self._dev(ocr_labels), self._dev(ocr_lengths),
                    self._dev(batch.gt_labels.reshape(n, L)),
                    self._dev(batch.gt_lengths.reshape(n)),
                    docs=dev_mask.any(dim=1).sum(), strips=flat_mask.sum())
