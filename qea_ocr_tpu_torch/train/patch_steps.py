"""Step functions of the patch trainer (counterpart of
`qea_ocr_tpu/train/patch_steps.py`): the reference's two-phase algorithm
(`train_nn_patch.py:225-345`) with only the black-box OCR left on the host.

  prep_extract       : UNet eval forward + strip gather -> (doc_out, strips)
  [host]             : OCR of selected strips, label-history update
  phase_a            : CRNN update: weighted label-history CTC on the clean
                       strips + CTC on the noisy (jitter) strips, as
                       fixed-shape masked batches
  phase_b            : UNet update: CTC(GT) through the strip gather with the
                       CRNN's batch statistics frozen + sec_loss_scalar *
                       MSE(doc, white), then greedy decode, CER and entropy
                       written into the per-strip tables
  phase_ab           : phase_a then phase_b (which sees the updated CRNN);
                       with `micro_steps=G`, G such pairs over doc-major
                       chunks of the batch
  prep_pretrain_step : UNet update on MSE(prep(x), x)
  val_forward        : prep_extract + CRNN eval + per-document loss + decode
  entropy_of         : CRNN eval + mean sequence entropy

Shapes: D documents x S strip slots flatten to N = D*S strip rows; ragged
quantities carry masks, and nothing in a step depends on the data's values
for its shapes or its control flow (no host read inside a step).

State: `make_steps` binds the two models and their optimizers. Where the JAX
functions take and return `ModelState`s, these update the models'
parameters and batch statistics, the optimizers' moments, and the CER and
entropy tables *in place*, and return the remaining values in the JAX
order. Every function leaves each model's train/eval mode as it found it.

Data parallelism (`make_steps(group=...)`): each rank passes its own rows
and every function computes what the JAX step computes over the global
batch (`parallel/multihost.py`): the losses divide by global counts, the
UNet's train-mode batch norm uses global statistics, the gradients are
summed over the group before the non-finite entries are zeroed, and the
tables take every rank's rows. The losses returned are the global ones, the
same on every rank, as are the parameters, moments and tables after a step.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
from torch import nn

from qea_ocr_tpu_torch.ops.ctc import (
    ctc_loss_mean, ctc_loss_samplewise, greedy_decode)
from qea_ocr_tpu_torch.ops.edit_distance import cer_from_labels
from qea_ocr_tpu_torch.ops.entropy import mean_sequence_entropy
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch
from qea_ocr_tpu_torch.parallel.multihost import (
    gather_rows, in_data_group, global_count, global_mean, reported,
    sum_gradients)
from qea_ocr_tpu_torch.parallel.tp import is_sharded, unsharded
from qea_ocr_tpu_torch.tracking.loss import weighted_ctc_loss
from qea_ocr_tpu_torch.train.state import scrub_nonfinite
from qea_ocr_tpu_torch.utils.metrics import span


@contextlib.contextmanager
def model_modes(train: tuple[nn.Module, ...] = (),
                frozen: tuple[nn.Module, ...] = ()):
    """Run with `train` models in train mode and `frozen` models in eval mode
    (batch statistics fixed; parameters still take gradients), restoring
    every model's mode afterwards."""
    models = (*train, *frozen)
    before = [m.training for m in models]
    try:
        for m in train:
            m.train()
        for m in frozen:
            m.eval()
        yield
    finally:
        for m, mode in zip(models, before):
            m.train(mode)


def optimizer_step(loss: torch.Tensor,
                   *pairs: tuple[torch.optim.Optimizer, nn.Module]) -> None:
    """One optimizer step on `loss` for each (optimizer, model) pair, the
    gradients summed over the current data group and then their non-finite
    entries zeroed. Gradients are taken for those models' parameters only,
    so a model left out is a constant of the loss and costs no backward
    work; a model under `fully_shard` reduces its gradients in hooks on its
    whole parameters, which the backward must reach, so with one the
    backward runs to every leaf (a model left out then gets gradients that
    its next step's `zero_grad` drops)."""
    params = [p for _, model in pairs for p in model.parameters()]
    for opt, _ in pairs:
        opt.zero_grad(set_to_none=True)
    with span("backward"):
        if any(is_sharded(model) for _, model in pairs):
            loss.backward()
        else:
            loss.backward(inputs=params)
    with span("optimizer"):
        sum_gradients(params)
        scrub_nonfinite(params)
        for opt, _ in pairs:
            opt.step()


def _chunk(x: torch.Tensor, G: int, dim: int = 0) -> tuple[torch.Tensor, ...]:
    """G equal doc-major chunks of `x` along `dim` (views)."""
    if x.shape[dim] % G:
        raise ValueError(f"micro_steps={G} does not divide a batch axis of "
                         f"{x.shape[dim]}")
    return x.chunk(G, dim=dim)


def make_steps(prep_model: nn.Module, crnn_model: nn.Module, charmap, *,
               prep_optimizer: torch.optim.Optimizer | None = None,
               crnn_optimizer: torch.optim.Optimizer | None = None,
               h_out: int = 32, w_out: int = 128,
               sec_loss_scalar: float = 1.0,
               phase_a_batch_rows: int = 2048,
               prep_eval_model: nn.Module | None = None,
               group=None) -> SimpleNamespace:
    """The step functions over `prep_model` (UNet) and `crnn_model`.

    `prep_eval_model`, if given, is a twin of `prep_model` over the same
    parameter and buffer tensors (`UNet.twin`) that may take another compute
    layout (`conv_impl="cmajor"`). The no-grad forwards, `prep_extract` and
    `val_forward`, run through it; every function that takes a gradient runs
    through `prep_model`. A twin that does not share `prep_model`'s tensors
    would read stale weights after the first update, so it is refused.

    The optimizers (`train.state.adam_l2`) are needed by the functions that
    update their model only. `phase_a_batch_rows` is the most strip rows
    (parts x N) for which phase A runs the history strips and all jitter
    copies through one concatenated CRNN call; above it each part is its own
    call, which holds fewer activations at once. The CRNN's batch statistics
    are frozen there, so the two give the same numbers.

    `group` (a `torch.distributed` process group, e.g. `dist.group.WORLD`,
    or a mesh's data group) makes every function one step over the global
    batch of the group's ranks (the module docstring); None keeps them
    single-process. A twin of a model under `fully_shard` reads its whole
    parameters through `parallel.tp.unsharded`."""
    pad_id = charmap.pad_id
    max_len = charmap.max_len
    if prep_eval_model is None:
        prep_eval_model = prep_model
    elif not prep_model.shares_state(prep_eval_model):
        raise ValueError(
            "prep_eval_model does not hold prep_model's parameter and buffer "
            "tensors: build it with prep_model.twin(...) once prep_model is "
            "on its device")

    def twin_view():
        """The twin holding `prep_model`'s whole parameters."""
        if prep_eval_model is prep_model or not is_sharded(prep_model):
            return contextlib.nullcontext()
        return unsharded(prep_model, prep_eval_model)

    def _optimizer(opt, name):
        if opt is None:
            raise ValueError(f"this step updates the {name}: give make_steps "
                             f"a {name}_optimizer")
        return opt

    def _per_doc_loss(scores, flat_labels, flat_lengths, strip_mask, doc_out):
        """Each real document contributes the mean over its own strips of
        the length-normalised CTC NLL plus sec_loss_scalar * MSE(doc,
        white); the result is the mean over documents with any valid strip
        (the reference's batch-size-1 weighting, batched). Padded documents
        (all-false strip_mask) contribute nothing."""
        D, S = strip_mask.shape
        with span("loss"):
            per = ctc_loss_samplewise(scores, flat_labels, flat_lengths,
                                      pad_id=pad_id)
            per = per / flat_lengths.clamp(min=1).to(per.dtype)
            m = strip_mask.to(per.dtype)
            per_doc_ctc = ((per.reshape(D, S) * m).sum(dim=1)
                           / m.sum(dim=1).clamp(min=1.0))
            per_doc_mse = ((doc_out - 1.0) ** 2).mean(dim=(1, 2, 3))
            per_doc = per_doc_ctc + sec_loss_scalar * per_doc_mse
            doc_mask = strip_mask.any(dim=1).to(per.dtype)
            return ((per_doc * doc_mask).sum()
                    / global_count(doc_mask.sum()).clamp(min=1.0))

    def _extract(images, bboxes, model=prep_model):
        D, S = bboxes.shape[:2]
        doc_out = model(images)
        strips = get_text_stack_batch(doc_out, bboxes, h_out, w_out)
        return doc_out, strips.reshape(D * S, 1, h_out, w_out)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prep_extract(images, bboxes):
        """UNet eval forward + strip gather: (doc_out (D, 1, H, W),
        strips (D*S, 1, h_out, w_out)), no gradient (phase A treats the
        UNet as frozen)."""
        with span("prep_extract"), twin_view(), \
                model_modes(frozen=(prep_eval_model,)):
            return _extract(images, bboxes, prep_eval_model)

    # ------------------------------------------------------------------
    def phase_a(strips, bb_mask, hist_labels, hist_lengths, hist_valid,
                loss_weights, jitter_images, jitter_labels, jitter_lengths,
                *, decaying: bool, inner_limit_skip: bool):
        """CRNN update; returns the loss.

          strips: (N, 1, h, w) UNet-cleaned strips (no gradient).
          bb_mask: (N,) bool, strips whose OCR labels arrived this step.
          hist_*: (N, W, ...) label-history targets (valid already includes
            bb_mask).
          loss_weights: (W,) decaying scalars or (N, W+1) per-sample weights.
          jitter_images: (I, N, 1, h, w) noisy strips (I inner loops, maybe
            0), jitter_labels (I, N, L), jitter_lengths (I, N).

        Loss = [weighted history CTC if inner_limit_skip] + sum_i CTC_mean_i:
        the reference's gradient accumulation over its inner loop is the sum
        of the losses before one optimizer step. The CRNN runs with frozen
        batch statistics."""
        opt = _optimizer(crnn_optimizer, "crnn")
        I = jitter_images.shape[0]
        N = strips.shape[0]
        parts = ([strips.detach()] if inner_limit_skip else []) \
            + [jitter_images[i] for i in range(I)]
        if not parts:
            raise ValueError("phase A has nothing to train on: "
                             "inner_limit_skip is false and there are no "
                             "jitter images")
        with span("phase_a"), model_modes(frozen=(crnn_model,)):
            if len(parts) * N <= phase_a_batch_rows:
                # time-major (T, B, V): the parts lie along axis 1
                part_scores = crnn_model(torch.cat(parts, dim=0)).split(
                    N, dim=1)
            else:
                part_scores = [crnn_model(p) for p in parts]
            with span("loss"):
                total = 0.0
                k = 0
                if inner_limit_skip:
                    total = total + weighted_ctc_loss(
                        part_scores[0], hist_labels, hist_lengths,
                        hist_valid, loss_weights, pad_id=pad_id,
                        decaying=decaying)
                    k = 1
                for i in range(I):
                    total = total + ctc_loss_mean(
                        part_scores[k + i], jitter_labels[i],
                        jitter_lengths[i], pad_id=pad_id,
                        sample_mask=bb_mask)
            optimizer_step(total, (opt, crnn_model))
        return reported(total)

    # ------------------------------------------------------------------
    def _phase_b_one(images, bboxes, strip_mask, gt_labels, cer_table,
                     ent_table, gt_lengths, strip_ids, *, update_crnn: bool):
        pairs = [(_optimizer(prep_optimizer, "prep"), prep_model)]
        if update_crnn:
            pairs.append((_optimizer(crnn_optimizer, "crnn"), crnn_model))
        D, S = bboxes.shape[:2]
        N = D * S
        flat_mask = strip_mask.reshape(N)
        flat_labels = gt_labels.reshape(N, max_len)
        flat_lengths = gt_lengths.reshape(N)

        with span("phase_b"):
            # UNet in train mode (its batch statistics move); CRNN with
            # frozen batch statistics, its parameters updated only when
            # update_crnn
            with model_modes(train=(prep_model,), frozen=(crnn_model,)):
                doc_out, strips = _extract(images, bboxes)
                scores = crnn_model(strips)
                loss = _per_doc_loss(scores, flat_labels, flat_lengths,
                                     strip_mask, doc_out)
                optimizer_step(loss, *pairs)

            # CER and entropy of every strip, written at the unmasked strip
            # ids
            with span("tables"), torch.no_grad():
                scores = scores.detach()
                dec, dec_len = greedy_decode(scores, pad_id=pad_id)
                cers = cer_from_labels(
                    dec[:, :max_len], dec_len.clamp(max=max_len),
                    flat_labels, flat_lengths)                       # (N,)
                ents = mean_sequence_entropy(scores)                 # (N,)
                # a masked row is sent to one slot past the table, which is
                # cut off again: it writes nothing (no stale value, no
                # data-dependent shape). In a data group every rank writes
                # every rank's rows.
                ids = gather_rows(torch.where(
                    flat_mask, strip_ids.reshape(N).long(),
                    cer_table.shape[0]))
                for table, values in ((cer_table, gather_rows(cers)),
                                      (ent_table, gather_rows(ents))):
                    grown = torch.cat([table, table.new_zeros(1)])
                    grown[ids] = values.to(table.dtype)
                    table.copy_(grown[:-1])
        metrics = dict(loss=reported(loss), cers=cers, decoded=dec,
                       decoded_len=dec_len)
        return doc_out.detach(), metrics, cer_table, ent_table

    def _stack_metrics(outs):
        """Per-chunk (doc_out, metrics) pairs -> one pair: documents and
        strip rows concatenated in order, the loss averaged over chunks."""
        ms = [m for _, m in outs]
        metrics = dict(
            loss=torch.stack([m["loss"] for m in ms]).mean(),
            cers=torch.cat([m["cers"] for m in ms]),
            decoded=torch.cat([m["decoded"] for m in ms]),
            decoded_len=torch.cat([m["decoded_len"] for m in ms]))
        return torch.cat([d for d, _ in outs]), metrics

    def phase_b(images, bboxes, strip_mask, gt_labels, cer_table, ent_table,
                gt_lengths, strip_ids, *, update_crnn: bool,
                micro_steps: int = 1):
        """UNet update (and the CRNN's when `update_crnn`) on CTC(GT) +
        MSE(doc, white), then the CER/entropy table update. With
        `micro_steps=G` the batch is taken as G doc-major chunks, one
        update each. Returns (doc_out, metrics, cer_table, ent_table) with
        metrics = dict(loss, cers (N,), decoded (N, T), decoded_len (N,))."""
        doc_args = (images, bboxes, strip_mask, gt_labels, gt_lengths,
                    strip_ids)
        if micro_steps <= 1:
            im, bb, sm, gl, glen, sid = doc_args
            return _phase_b_one(im, bb, sm, gl, cer_table, ent_table, glen,
                                sid, update_crnn=update_crnn)
        outs = []
        for im, bb, sm, gl, glen, sid in zip(
                *(_chunk(a, micro_steps) for a in doc_args)):
            outs.append(_phase_b_one(im, bb, sm, gl, cer_table, ent_table,
                                     glen, sid, update_crnn=update_crnn)[:2])
        return (*_stack_metrics(outs), cer_table, ent_table)

    # ------------------------------------------------------------------
    def phase_ab(images, bboxes, strip_mask, gt_labels, cer_table, ent_table,
                 gt_lengths, strip_ids, strips, bb_mask, hist_labels,
                 hist_lengths, hist_valid, loss_weights, jitter_images,
                 jitter_labels, jitter_lengths, *, decaying: bool,
                 inner_limit_skip: bool, update_crnn: bool,
                 micro_steps: int = 1, micro_refresh: bool = False):
        """Phase A then phase B on one batch; phase B sees the CRNN that
        phase A updated. Returns phase B's values and then phase A's loss:
        (doc_out, metrics, cer_table, ent_table, loss_a).

        `micro_steps=G` takes the batch as G doc-major chunks (chunk g owns
        documents [g*D/G, (g+1)*D/G) and their strip rows) and runs the pair
        on each in turn, which is what G batches of D/G documents would do;
        the losses are averaged over chunks. Phase A then reads strips
        that were extracted once, before the batch's first update.
        `micro_refresh=True` instead re-extracts each chunk's history strips
        with the current UNet (one more eval forward per chunk), the
        reference's pairing of fresh pixels with the tracked label history;
        the jitter images keep the pixels their OCR labels were read from."""
        with span("phase_ab"):
            a_kw = dict(decaying=decaying, inner_limit_skip=inner_limit_skip)
            if micro_steps <= 1:
                loss_a = phase_a(strips, bb_mask, hist_labels, hist_lengths,
                                 hist_valid, loss_weights, jitter_images,
                                 jitter_labels, jitter_lengths, **a_kw)
                return (*_phase_b_one(images, bboxes, strip_mask, gt_labels,
                                      cer_table, ent_table, gt_lengths,
                                      strip_ids, update_crnn=update_crnn),
                        loss_a)
            G = micro_steps
            doc_xs = zip(*(_chunk(a, G) for a in (
                images, bboxes, strip_mask, gt_labels, gt_lengths,
                strip_ids)))
            strip_xs = zip(*(_chunk(a, G) for a in (
                strips, bb_mask, hist_labels, hist_lengths, hist_valid)))
            # (W,) decaying scalars are shared by every chunk
            lw_xs = ([loss_weights] * G if decaying
                     else _chunk(loss_weights, G))
            # the jitter stacks are (I, N, ...): split the strip-row axis
            jit_xs = zip(*(_chunk(a, G, dim=1) for a in (
                jitter_images, jitter_labels, jitter_lengths)))
            outs, losses_a = [], []
            for (im, bb, sm, gl, glen, sid), (st, bbm, hl, hlen, hv), lw, \
                    (ji, jl, jlen) in zip(doc_xs, strip_xs, lw_xs, jit_xs):
                if micro_refresh:
                    st = prep_extract(im, bb)[1]
                losses_a.append(phase_a(st, bbm, hl, hlen, hv, lw, ji, jl,
                                        jlen, **a_kw))
                outs.append(_phase_b_one(
                    im, bb, sm, gl, cer_table, ent_table, glen, sid,
                    update_crnn=update_crnn)[:2])
            return (*_stack_metrics(outs), cer_table, ent_table,
                    torch.stack(losses_a).mean())

    # ------------------------------------------------------------------
    def prep_pretrain_step(images):
        """Identity/denoise pretraining: one UNet update on MSE(prep(x), x),
        which gives the preprocessor a readable starting point before the
        budget loop. Returns the loss."""
        opt = _optimizer(prep_optimizer, "prep")
        with model_modes(train=(prep_model,)):
            loss = global_mean((prep_model(images) - images) ** 2)
            optimizer_step(loss, (opt, prep_model))
        return reported(loss)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def val_forward(images, bboxes, strip_mask, gt_labels, gt_lengths):
        """Validation forward: (doc_out, strips, decoded (N, T) int32,
        decoded lengths (N,) int32, loss scalar)."""
        D, S = bboxes.shape[:2]
        N = D * S
        with twin_view(), model_modes(frozen=(prep_eval_model, crnn_model)):
            doc_out, strips = _extract(images, bboxes, prep_eval_model)
            scores = crnn_model(strips)
            loss = _per_doc_loss(scores, gt_labels.reshape(N, max_len),
                                 gt_lengths.reshape(N), strip_mask, doc_out)
            dec, dec_len = greedy_decode(scores, pad_id=pad_id)
        return doc_out, strips, dec, dec_len, reported(loss)

    @torch.no_grad()
    def entropy_of(strips):
        """(N, 1, h, w) strips -> (N,) mean normalised CRNN entropy."""
        with model_modes(frozen=(crnn_model,)):
            return mean_sequence_entropy(crnn_model(strips))

    return SimpleNamespace(
        prep_extract=in_data_group(group, prep_extract), phase_a=in_data_group(group, phase_a),
        phase_b=in_data_group(group, phase_b), phase_ab=in_data_group(group, phase_ab),
        prep_pretrain_step=in_data_group(group, prep_pretrain_step),
        val_forward=in_data_group(group, val_forward), entropy_of=entropy_of)
