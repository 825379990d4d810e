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
    selected-samples bitmap).

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

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import PatchDocuments
from qea_ocr_tpu_torch.data.pipeline import (
    DocBatch, batch_iterator, blank_docbatch, collate_docs,
    default_num_workers, pad_docbatch)
from qea_ocr_tpu_torch.models.attention import HistoryAttention
from qea_ocr_tpu_torch.models.proxy import build_proxy
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.transforms import host_jitter
from qea_ocr_tpu_torch.parallel.mesh import (
    DATA_AXIS, make_mesh, put_replicated)
from qea_ocr_tpu_torch.parallel.multihost import (
    broadcast_object, pinned_subset, process_shard, process_sum,
    rank_device)
from qea_ocr_tpu_torch.parallel.tp import (
    MODEL_AXIS, make_mesh_2d, optimizer_state_whole, put_tp,
    state_dict_whole)
from qea_ocr_tpu_torch.selection import (
    GLOBAL_METHODS, is_global, membership_mask, select_batch)
from qea_ocr_tpu_torch.tracking import (
    LabelHistory, attention_weights, decaying_weights, levenshtein_weights,
    weightgenerator_factory)
from qea_ocr_tpu_torch.train.patch_steps import make_steps
from qea_ocr_tpu_torch.train.state import (
    adam_l2, ema_update, parameters_swapped, set_learning_rate)
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import (
    ExpDirs, load_checkpoint, load_json, resolve_side_shard, save_checkpoint,
    save_image_png, save_json)
from qea_ocr_tpu_torch.utils.metrics import (
    MetricsLogger, StepTimer, maybe_profile)


@dataclasses.dataclass
class PatchTrainerConfig:
    # reference flag surface (patch_cli.py:10-156)
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
    exp_name: str = "test_patch"
    train_subset_size: Optional[int] = None
    val_subset_size: Optional[int] = None
    weight_decay: float = 5e-4
    cers_ocr_path: Optional[str] = None
    image_prop: Optional[float] = None
    discount_factor: float = 1.0
    update_CRNN: bool = False
    window_size: int = 1
    query_dim: int = 32
    emb_dim: int = 256
    attn_activation: str = "sigmoid"
    weightgen_method: str = "decaying"
    decay_factor: float = 0.7
    pruning_artifact: Optional[str] = None
    optim_crnn_path: Optional[str] = None  # full-state resume (parameters and
    optim_prep_path: Optional[str] = None  # Adam moments), --optim_*_path
    tracked_labels_path: Optional[str] = None  # resume label history (JSON)
    profile_dir: Optional[str] = None          # torch.profiler trace output
    prep_pretrain_epochs: int = 0  # identity/denoise pretraining of the UNet
                                   # before the budget loop (skipped when a
                                   # --prep_model checkpoint is loaded)
    prep_pretrain_lr: float = 1e-3 # pretraining uses its own (higher) rate
    async_ocr: bool = True    # pipeline the host OCR of batch k+1 over the
                              # device work of batch k (strips one prep
                              # update stale relative to the synchronous
                              # reference; identical budget accounting).
                              # False restores reference-exact synchronous
                              # querying.
    data_parallel: bool = False  # shard document batches over the ranks of
                                 # the process group (module docstring)
    tensor_parallel: int = 0     # T > 0: parameters and moments sharded
                                 # over model groups of T ranks
    prep_ema: float = 0.0  # >0: keep an exponential moving average of the
                           # prep parameters (decay = this value, updated
                           # after every phase-B step) and use it for
                           # validation and checkpoints. Seeded after
                           # pretraining and warm start, so it never blends
                           # untrained parameters.
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
    corruption: Optional[dict] = None
    doc_size: tuple = C.DOC_SIZE
    lstm_hidden: int = 256
    unet_features: int = 32
    use_wandb: bool = False
    optuna_trial: object = None
    # the port's additions
    proxy: str = "crnn"    # models/proxy.py: crnn or svtr-l
    device: str = "cuda"   # torch device; a missing GPU is an error


class TrainNNPrep:
    """Patch-dataset two-phase trainer."""

    def __init__(self, cfg: PatchTrainerConfig):
        self.cfg = cfg
        self.device = resolve_device(rank_device(cfg.device))
        self.charmap = CharMap.default()
        self.dirs = ExpDirs(cfg.exp_base_path).create()
        np.random.seed(cfg.random_seed)
        self._np_rng = np.random.default_rng(cfg.random_seed)
        self._gen = torch.Generator().manual_seed(cfg.random_seed)

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
        self.val_set_size = len(self.validation_set)

        backend = get_ocr_helper(cfg.ocr)
        if backend is None:
            raise ValueError(f"unknown OCR backend {cfg.ocr!r}")
        self.ocr = OcrQueryEngine(backend, self.charmap)

        # ----------------------------------------------------------- models
        # The grad model is pinned to the library route; the twin over the
        # same tensors resolves `auto` (QEA_CONV_IMPL), so an opt-in to the
        # channel-major kernel reroutes the no-grad forwards only. It is
        # made once the grad model is on its device. Checkpoints are the
        # same for every conv_impl.
        seeds = [cfg.random_seed * 3 + i for i in range(3)]
        self.prep_model = UNet(
            init_features=cfg.unet_features, conv_impl="xla",
            generator=torch.Generator().manual_seed(seeds[0])).to(self.device)
        self.crnn_model = build_proxy(
            cfg.proxy, self.charmap.vocab_size, lstm_hidden=cfg.lstm_hidden,
            generator=torch.Generator().manual_seed(seeds[1])).to(self.device)
        tp = cfg.tensor_parallel
        self.prep_optimizer = adam_l2(self.prep_model.parameters(),
                                      cfg.lr_prep, cfg.weight_decay,
                                      sharded=bool(tp))
        self.crnn_optimizer = adam_l2(self.crnn_model.parameters(),
                                      cfg.lr_crnn, cfg.weight_decay,
                                      sharded=bool(tp))
        if cfg.prep_model:
            # model-only warm start (fresh optimizer, reference torch.load)
            load_checkpoint(cfg.prep_model, self.prep_model)
        if cfg.crnn_model:
            load_checkpoint(cfg.crnn_model, self.crnn_model)
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

        # ------------------------------------------------- tracking/weights
        self.weightgen_method = weightgenerator_factory(cfg.weightgen_method)
        self.history = LabelHistory(
            self.dataset.num_strips, cfg.window_size, self.charmap)
        if cfg.tracked_labels_path:
            # multi-process runs shard side-state per rank (.pN suffix,
            # _save_side_jsons); resume prefers this rank's shard, so one
            # flag value serves every rank
            self.history.load_json(
                resolve_side_shard(cfg.tracked_labels_path, self._rank),
                self.dataset.name_to_id)
        self.attn_model = None
        if cfg.weightgen_method == "self_attention":
            self.attn_model = HistoryAttention(
                char_vocab_size=self.charmap.vocab_size,
                emb_size=cfg.emb_dim, query_dim=cfg.query_dim,
                window_size=cfg.window_size, activation=cfg.attn_activation,
                generator=torch.Generator().manual_seed(seeds[2]),
            ).to(self.device).eval()

        # ------------------------------------------------- CER/side state
        n = self.dataset.num_strips
        cers0 = np.ones((n,), np.float32)
        self.selected_samples: Dict[str, List[bool]] = {}
        if cfg.cers_ocr_path:
            seed = load_json(cfg.cers_ocr_path)
            for name, cer in seed.items():
                if name in self.dataset.name_to_id:
                    cers0[self.dataset.name_to_id[name]] = cer
            for name in seed:
                self.selected_samples[name] = [False] * cfg.epochs
        # the steps update both tables in place
        self.cer_table = torch.from_numpy(cers0).to(self.device)
        self.ent_table = torch.ones((n,), dtype=torch.float32,
                                    device=self.device)
        self.all_cers: Dict[str, List[float]] = {}
        self.global_bitmap = np.zeros((n,), bool)

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

        self.logger = MetricsLogger(
            cfg.exp_base_path if self._rank == 0 else None,
            use_wandb=cfg.use_wandb and self._rank == 0)
        self.timer = StepTimer()
        self.ema_params: Optional[List[torch.Tensor]] = None  # _train_impl
        # (phase-B loss, phase-A loss) of every step, as the host read them
        self.step_losses: List[tuple] = []

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
        self.group = None           # the data group the steps reduce over
        self._model_group = None    # tensor parallel: one OCR a model group
        self._rank, self._world = 0, 1   # global rank and world size
        self._pi, self._pc = 0, 1        # data index and data-axis size
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

    def _write_checkpoint(self, path: str, model, optimizer) -> None:
        """Rank 0 writes `model` and `optimizer`; under tensor parallelism
        every rank first takes part in gathering the shards whole, so the
        checkpoint is the single-process one."""
        if self.cfg.tensor_parallel:
            model = state_dict_whole(model)
            optimizer = optimizer_state_whole(optimizer)
        if self._rank == 0:
            save_checkpoint(path, model, optimizer)

    # ------------------------------------------------------------------
    def _eval_prep(self):
        """The prep as validation and checkpoints see it: with the EMA
        parameters in place of the raw ones when the EMA is on (the
        deployable artifact). The swap is in place, so the twin sees it."""
        if self.ema_params is None:
            return contextlib.nullcontext()
        return parameters_swapped(self.prep_model, self.ema_params)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """This rank's rows (a batch-dimension array) on its device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

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

    # ------------------------------------------------------------------
    def _select(self, batch: DocBatch, epoch: int) -> np.ndarray:
        """The strips that query the OCR this step: (D, S) bool numpy."""
        cfg = self.cfg
        if (not cfg.minibatch_subset) or epoch < cfg.warmup_epochs:
            return np.asarray(batch.strip_mask)
        valid = self._dev(batch.strip_mask)
        ids = self._dev(batch.strip_ids)
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

    # ------------------------------------------------------------------
    def train(self):
        with maybe_profile(self.cfg.profile_dir):
            return self._train_impl()

    def _prep_pretrain(self):
        """Identity/denoise pretraining epochs for the UNet."""
        cfg = self.cfg
        set_learning_rate(self.prep_optimizer, cfg.prep_pretrain_lr)
        for epoch in range(cfg.prep_pretrain_epochs):
            total, n = 0.0, 0
            for batch in batch_iterator(
                    self.dataset, self._dl, collate_docs,
                    seed=cfg.random_seed + 7000, epoch=epoch,
                    indices=self._local_train_indices):
                loss = self.steps.prep_pretrain_step(self._dev(batch.images))
                total += float(loss)
                n += 1
            print(f"[prep-pretrain] epoch {epoch} mse {total / max(1, n):.5f}")
        set_learning_rate(self.prep_optimizer, cfg.lr_prep)

    def _train_impl(self):
        cfg = self.cfg
        if cfg.prep_pretrain_epochs and not cfg.prep_model:
            self._prep_pretrain()
        if cfg.prep_ema > 0.0:
            self.ema_params = [p.detach().clone()
                               for p in self.prep_model.parameters()]
        D = cfg.batch_docs
        L = self.charmap.max_len
        W = cfg.window_size
        n_jitter = max(0, cfg.inner_limit - (1 if cfg.inner_limit_skip else 0)) \
            if cfg.inner_limit else 0
        best_val_acc, best_val_epoch = 0.0, 0
        total_crnn_updates = 0
        # reference ledger split (`train_nn_patch.py:199,298,398,410-413`):
        # "Total Black-Box Calls" counts train queries only; the cumulative
        # train+val ledger is its own metric.
        total_train_bb_calls = 0
        total_train_val_bb_calls = 0

        for epoch in range(cfg.start_epoch, cfg.epochs):
            if is_global(cfg.minibatch_subset):
                self._global_select(epoch)
            indices = self._local_train_indices
            if cfg.image_prop:
                # a per-rank subsample of the pinned subset: the global
                # proportion holds, and so does lockstep (equal subsets)
                k = int(cfg.image_prop * len(indices))
                indices = self._np_rng.permutation(indices)[:k]
            self.ocr.reset_epoch()
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
            for batch in batch_iterator(
                    self.dataset, self._dl, collate_docs,
                    seed=cfg.random_seed, epoch=epoch, indices=indices,
                    num_workers=default_num_workers(), prefetch=2):
                work = self._prepare_work(batch, epoch, n_jitter, epoch_print)
                epoch_print = False
                if not cfg.async_ocr:
                    account(self._process_work(work, n_jitter, L, W))
                else:
                    # one-deep pipeline: the device works on batch k while
                    # the host OCRs batch k+1 (submitted in _prepare_work)
                    if pending is not None:
                        account(self._process_work(pending, n_jitter, L, W))
                    pending = work
            if pending is not None:
                account(self._process_work(pending, n_jitter, L, W))
            total_crnn_updates += totals["crnn_updates"]

            if cfg.minibatch_subset:
                self._save_side_jsons(epoch)

            # train-only snapshot: _validate() queries the engine too, and
            # the reference keeps "Black-Box Calls" train-only
            # (`train_nn_patch.py:298-299,411`)
            epoch_bb_calls = self.ocr.epoch_calls
            if self._world > 1:
                # the global ledger: each rank queried its own documents
                epoch_bb_calls = int(process_sum([epoch_bb_calls])[0])
            print(f"Epoch BB calls - {epoch_bb_calls}")
            val = self._validate()
            total_train_bb_calls += epoch_bb_calls
            total_train_val_bb_calls += epoch_bb_calls + val["bb_calls"]
            # a batch's phase-B loss is a mean over its D documents; x D
            # recovers the per-document sum, and the reference divides by
            # the full train set size (`train_nn_patch.py:350`)
            train_loss = totals["loss"] * D / max(1, self.train_set_size)
            crnn_train_loss = totals["crnn_loss"] / max(1, epoch_bb_calls)

            metrics_out = {
                "CRNN_accuracy": val["crnn_acc"],
                f"{cfg.ocr}_accuracy": val["ocr_acc"],
                "CRNN_CER": val["crnn_cer"],
                f"{cfg.ocr}_cer": val["ocr_cer"],
                "Epoch": epoch + 1,
                "train_loss": train_loss,
                "val_loss": val["loss"],
                "Total Black-Box Calls": total_train_bb_calls,
                "Black-Box Calls": epoch_bb_calls,
                "Train + Val BB Calls": epoch_bb_calls + val["bb_calls"],
                "Total Train + Val BB Calls": total_train_val_bb_calls,
                "Total CRNN Updates": total_crnn_updates,
                "CRNN Updates": totals["crnn_updates"],
                "CRNN_loss": crnn_train_loss,
                "CRNN_OCR_Matching_ACC": val["match_acc"],
                "CRNN_OCR_Matching_CER": val["match_cer"],
            }
            metrics_out.update(self.timer.summary())
            # host clock over the epoch's training, side JSONs and
            # validation (the checkpoint writes below come after it)
            metrics_out["time/epoch_s"] = time.perf_counter() - epoch_t0
            self.logger.log(metrics_out)

            # sample cleaned image (+ original once), by rank 0
            if totals["doc_out"] is not None and self._rank == 0:
                save_image_png(
                    totals["doc_out"][0].float().cpu().numpy(),
                    os.path.join(self.dirs.img_out, f"out_{epoch}.png"))
                if epoch == 0:
                    save_image_png(
                        totals["batch"].images[0],
                        os.path.join(self.dirs.img_out, "out_original.png"))

            # validation's metrics are global sums, so the names and the
            # best-checkpoint condition agree on every rank
            ocr_acc = val["ocr_acc"]
            with self._eval_prep():
                self._write_checkpoint(os.path.join(
                    self.dirs.ckpts,
                    f"Prep_model_{epoch}_{ocr_acc * 100:.2f}"),
                    self.prep_model, self.prep_optimizer)
                if ocr_acc > best_val_acc:
                    self._write_checkpoint(
                        os.path.join(self.dirs.ckpts, "Prep_model_best"),
                        self.prep_model, self.prep_optimizer)
            self._write_checkpoint(
                os.path.join(self.dirs.ckpts, f"CRNN_model_{epoch}"),
                self.crnn_model, self.crnn_optimizer)
            if ocr_acc > best_val_acc:
                best_val_acc, best_val_epoch = ocr_acc, epoch
                self.logger.update_summary({
                    "best_val_acc": best_val_acc,
                    "best_val_epoch": best_val_epoch,
                })
            self._maybe_optuna(ocr_acc * 100, epoch)
        print("Training Completed.")
        return best_val_acc, best_val_epoch

    # ------------------------------------------------------------------
    def _prepare_work(self, batch: DocBatch, epoch: int, n_jitter: int,
                      epoch_print: bool) -> dict:
        """Extract strips with the current prep, select the query budget,
        and send the selected strips to the black-box OCR (a synchronous
        query, or an asynchronous submit with `async_ocr`). The host-side noise is drawn here, so the
        OCR and phase A see the same jittered images."""
        cfg = self.cfg
        images = self._dev(batch.images)
        bboxes = self._dev(batch.bboxes)
        with self.timer.time("prep_extract"):
            _, strips = self.steps.prep_extract(images, bboxes)
        bb_mask = self._select(batch, epoch)              # (D, S) bool
        n = bb_mask.size                                  # strip rows
        flat_bb = bb_mask.reshape(n)
        sel_rows = np.nonzero(flat_bb)[0]
        sel_ids = batch.strip_ids.reshape(n)[sel_rows]
        if epoch_print:
            print(f"Total Samples - {int(batch.strip_mask.sum())}")
            print(f"OCR Samples - {len(sel_rows)}")
        for d in range(len(batch.doc_names)):
            for j in np.nonzero(bb_mask[d])[0]:
                if j < len(batch.strip_names[d]):
                    self.selected_samples.setdefault(
                        batch.strip_names[d][j],
                        [False] * cfg.epochs)[epoch] = True

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
            for _ in range(n_jitter):
                noisy = self._noise(sel_strips)
                with self.timer.time("ocr_issue"):
                    work["jitter"].append((noisy, self._ask(noisy, wait)))
        return work

    def _process_work(self, work: dict, n_jitter: int, L: int,
                      W: int) -> dict:
        """Phase A (consuming the OCR results) and phase B for one prepared
        batch."""
        cfg = self.cfg
        batch: DocBatch = work["batch"]
        strips = work["strips"]
        sel_rows = work["sel_rows"]
        sel_ids = work["sel_ids"]
        crnn_loss = 0.0
        crnn_updates = 0
        doc_args = (work["images"], work["bboxes"],
                    self._dev(batch.strip_mask), self._dev(batch.gt_labels),
                    self.cer_table, self.ent_table,
                    self._dev(batch.gt_lengths), self._dev(batch.strip_ids))

        if cfg.inner_limit:
            strip_hw = tuple(strips.shape[2:])
            n = len(batch.doc_names) * cfg.max_strips     # strip rows
            hist_labels = np.full((n, W, L), self.charmap.pad_id, np.int32)
            hist_lengths = np.zeros((n, W), np.int32)
            hist_valid = np.zeros((n, W), bool)
            # asked for a clean read when any strip was selected (under
            # tensor parallelism only one rank of a model group holds it)
            if cfg.inner_limit_skip and len(sel_rows):
                with self.timer.time("ocr_wait"):
                    res = self._resolve(work["clean"])
                lw = self._gen_weights(sel_ids)     # pre-update history
                if cfg.weightgen_method == "decaying":
                    loss_weights = lw
                else:
                    loss_weights = torch.zeros((n, W + 1), device=self.device)
                    loss_weights[self._dev(sel_rows)] = lw
                self.history.add(sel_ids, res.labels, res.lengths, res.texts)
                labs, lens, valid = self.history.gather(sel_ids)
                hist_labels[sel_rows] = labs
                hist_lengths[sel_rows] = lens
                hist_valid[sel_rows] = valid
            elif cfg.weightgen_method == "decaying" or not cfg.inner_limit_skip:
                loss_weights = decaying_weights(cfg.decay_factor, W,
                                                self.device)
            else:
                # a batch with no selected strip under a per-sample weight
                # generator (e.g. a global bitmap missing all of its
                # documents): the tracking loss is fully masked, and the
                # weights keep their (n, W+1) shape
                loss_weights = torch.zeros((n, W + 1), device=self.device)

            jitter_images = np.ones((n_jitter, n, 1, *strip_hw), np.float32)
            jitter_labels = np.full((n_jitter, n, L), self.charmap.pad_id,
                                    np.int32)
            jitter_lengths = np.zeros((n_jitter, n), np.int32)
            for i, (noisy, pending) in enumerate(work["jitter"]):
                with self.timer.time("ocr_wait"):
                    res = self._resolve(pending)
                jitter_images[i, sel_rows] = noisy
                jitter_labels[i, sel_rows] = res.labels
                jitter_lengths[i, sel_rows] = res.lengths

            with self.timer.time("phase_ab"):
                doc_out, metrics, _, _, loss = self.steps.phase_ab(
                    *doc_args, strips, self._dev(work["flat_bb"]),
                    self._dev(hist_labels), self._dev(hist_lengths),
                    self._dev(hist_valid), loss_weights,
                    self._dev(jitter_images), self._dev(jitter_labels),
                    self._dev(jitter_lengths),
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

        if self.ema_params is not None:
            ema_update(self.ema_params, self.prep_model.parameters(),
                       cfg.prep_ema)

        if cfg.minibatch_subset:
            D, S = len(batch.doc_names), cfg.max_strips
            cers_np = metrics["cers"].float().cpu().numpy().reshape(D, S)
            for d in range(D):
                for j in np.nonzero(batch.strip_mask[d])[0]:
                    name = batch.strip_names[d][j]
                    self.all_cers.setdefault(name, []).append(
                        float(cers_np[d, j]))

        loss_b = float(metrics["loss"])
        self.step_losses.append((loss_b, crnn_loss))
        return dict(loss=loss_b, crnn_loss=crnn_loss,
                    crnn_updates=crnn_updates, doc_out=doc_out, batch=batch)

    # ------------------------------------------------------------------
    def _global_select(self, epoch: int):
        # the table is the same on every rank (every rank writes every
        # rank's rows), and so is the stream below: the same bitmap
        cfg = self.cfg
        cers = self.cer_table.cpu().numpy()
        num = max(1, int(round(
            (1 - cfg.minibatch_subset_prop) * self.dataset.num_strips)))
        fn = GLOBAL_METHODS[cfg.minibatch_subset]
        # a stream of its own per epoch (not self._np_rng, whose state
        # depends on data-dependent noise draws)
        rng = np.random.default_rng((cfg.random_seed, 9173, epoch))
        self.global_bitmap = fn(rng, cers, num)

    # ------------------------------------------------------------------
    def _validate(self):
        cfg = self.cfg
        D = cfg.batch_docs
        agg = dict(crnn_crt=0.0, crnn_cer=0.0, ocr_crt=0.0, ocr_cer=0.0,
                   match_crt=0.0, match_cer=0.0, loss=0.0)
        label_count = 0
        doc_count = 0
        bb_calls_before = self.ocr.total_calls
        with self._eval_prep():
            for batch in self._val_batches():
                nd, nlab = self._validate_batch(batch, agg)
                doc_count += nd
                label_count += nlab
        n_docs = max(1, doc_count)
        lc = max(1, label_count)
        print(f"Validation Dataset Calls - {label_count}")
        return dict(
            crnn_acc=agg["crnn_crt"] / lc,
            ocr_acc=agg["ocr_crt"] / lc,
            match_acc=agg["match_crt"] / lc,
            crnn_cer=agg["crnn_cer"] / n_docs,
            ocr_cer=agg["ocr_cer"] / n_docs,
            match_cer=agg["match_cer"] / n_docs,
            loss=agg["loss"] / n_docs,
            bb_calls=int(process_sum(
                [self.ocr.total_calls - bb_calls_before])[0]),
        )

    def _val_batches(self):
        """This rank's validation batches, all of `batch_docs / data-axis
        size` documents. Single-process: the whole set in order, the tail
        padded with mask-zero documents so that every document is scored
        (the reference iterates them all, `train_nn_patch.py:366-398`).
        Over several ranks each window of `batch_docs` documents is split
        into per-rank slices, as training batches are; a rank whose slice
        is empty feeds an all-padding batch, so the ranks step in
        lockstep."""
        D, Dl = self.cfg.batch_docs, self._dl
        if self._pc == 1:
            for batch in batch_iterator(
                    self.validation_set, D, collate_docs,
                    shuffle=False, drop_last=False,
                    num_workers=default_num_workers(), prefetch=2):
                yield pad_docbatch(batch, D) \
                    if batch.images.shape[0] != D else batch
            return
        template = None
        for start in range(0, self.val_set_size, D):
            window = np.arange(start, min(start + D, self.val_set_size))
            local_idx = window[self._pi * Dl:(self._pi + 1) * Dl]
            samples = [self.validation_set[int(i)] for i in local_idx]
            if samples:
                template = pad_docbatch(collate_docs(samples), Dl)
                yield template
            else:
                if template is None:
                    template = pad_docbatch(
                        collate_docs([self.validation_set[0]]), Dl)
                yield blank_docbatch(template, Dl)

    def _validate_batch(self, batch: DocBatch, agg: dict):
        """Score one validation batch into `agg`; returns its counts of real
        documents and valid strips. Over several ranks `batch` is this
        rank's slice, and the sums and counts are global."""
        L = self.charmap.max_len
        n = batch.strip_mask.size          # strip rows
        dev_mask = self._dev(batch.strip_mask)
        doc_out, strips, dec, dec_len, loss = self.steps.val_forward(
            self._dev(batch.images), self._dev(batch.bboxes), dev_mask,
            self._dev(batch.gt_labels), self._dev(batch.gt_lengths))
        flat_mask = dev_mask.reshape(n)
        gt = self._dev(batch.gt_labels.reshape(n, L))
        gt_len = self._dev(batch.gt_lengths.reshape(n))
        # host OCR on the cleaned strips (costed: the train + val ledger)
        rows = np.nonzero(batch.strip_mask.reshape(n))[0]
        ocr_labels = np.full((n, L), self.charmap.pad_id, np.int32)
        ocr_lengths = np.zeros((n,), np.int32)
        if len(rows):
            res = self._resolve(self._ask(
                strips[self._dev(rows)].float().cpu().numpy(), wait=True))
            ocr_labels[rows] = res.labels
            ocr_lengths[rows] = res.lengths
        ocr_labels = self._dev(ocr_labels)
        ocr_lengths = self._dev(ocr_lengths)
        dec_c = dec[:, :L]
        dec_l = dec_len.clamp(max=L)
        crt, cer, _ = compare_labels_device(dec_c, dec_l, gt, gt_len,
                                            flat_mask)
        t_crt, t_cer, _ = compare_labels_device(
            ocr_labels, ocr_lengths, gt, gt_len, flat_mask)
        m_crt, m_cer, _ = compare_labels_device(
            dec_c, dec_l, ocr_labels, ocr_lengths, flat_mask)
        # padded documents have no valid strip; every real one has at least
        # one (the dataset injects a dummy ' ')
        sums = torch.stack([x.float() for x in (
            crt, cer, t_crt, t_cer, m_crt, m_cer, dev_mask.any(dim=1).sum(),
            flat_mask.sum())])
        if self.group is not None:
            dist.all_reduce(sums, group=self.group)
        crt, cer, t_crt, t_cer, m_crt, m_cer, real_docs, valid_strips = \
            sums.tolist()
        real_docs, valid_strips = int(real_docs), int(valid_strips)
        agg["crnn_crt"] += crt; agg["crnn_cer"] += cer
        agg["ocr_crt"] += t_crt; agg["ocr_cer"] += t_cer
        agg["match_crt"] += m_crt; agg["match_cer"] += m_cer
        # the batch loss is a mean over the batch's real documents; x
        # real_docs recovers the per-document sum, for the reference's
        # /val_set_size denominator (`train_nn_patch.py:396`)
        agg["loss"] += float(loss) * real_docs
        return real_docs, valid_strips

    # ------------------------------------------------------------------
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

    def _save_side_jsons(self, epoch: int):
        # side-state is the rank's own (documents are pinned to ranks):
        # over several ranks each writes its shard, suffixed .pN
        sfx = f".p{self._rank}" if self._world > 1 else ""

        def path(dirname, name):
            base, ext = os.path.splitext(name)
            return os.path.join(dirname, base + sfx + ext)

        for name in (f"tracked_labels_{epoch}.json",
                     "tracked_labels_current.json"):
            self.history.save_json(path(self.dirs.tracked_labels, name),
                                   self.dataset.id_to_name)
        save_json(self.selected_samples,
                  path(self.dirs.selected_samples,
                       "selected_samples_current.json"))
        save_json(self.all_cers, path(self.dirs.cers, "all_cers.json"))
