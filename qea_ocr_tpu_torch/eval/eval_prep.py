"""Preprocessor evaluation: OCR accuracy/CER on cleaned images (counterpart
of `qea_ocr_tpu/eval/eval_prep.py`).

Counterpart of reference `eval_prep.py:15-205`:
  * patch path (`eval_patch`, :110-175): per document, extract strips from
    the cleaned output, OCR them, exact-match% + avg CER vs GT; optional
    baseline on the original strips (`--show_orig`); wildreceipt strips
    spaces from OCR output (:128-129,147-148);
  * area path (`eval_area`, :70-108): batch OCR on cleaned word crops.

Documents go through the UNet's no-grad forward and the strip gather (the
gather kernel on a CUDA device) in batches; CER aggregation runs on the
device. The UNet is built with `conv_impl="auto"`, so `QEA_CONV_IMPL=cmajor`
sends its forward through the hand-written channel-major conv kernel; a
geometry that route does not cover raises rather than taking cuDNN. The
reference's `--dataset pos` dispatch bug (README said pos, code KeyErrors)
is fixed as in the JAX package, by accepting both.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import numpy as np
import torch

from qea_ocr_tpu_torch import config as C
from qea_ocr_tpu_torch.data.datasets import (
    ImgDataset, PatchDocuments, SyntheticWordDataset)
from qea_ocr_tpu_torch.data.pipeline import (
    batch_iterator, collate_docs, collate_words, pad_docbatch, word_batch_to)
from qea_ocr_tpu_torch.models.unet import UNet
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import load_checkpoint, save_image_grid


@dataclasses.dataclass
class EvalPrepConfig:
    prep_path: str = "./outputs/prep_trained_model/"
    dataset: str = "patch_dataset"      # patch_dataset | vgg | pos | wildreceipt | synthetic*
    ocr: str = "Tesseract"
    batch_size: int = 64
    data_base_path: str = "."
    show_orig: bool = False
    show_txt: bool = False
    show_img: bool = False
    # architecture + synthetic knobs
    unet_features: int = 32
    batch_docs: int = 2
    max_strips: int = 32
    doc_size: tuple = C.DOC_SIZE
    synthetic_docs: int = 8
    synthetic_size: int = 64
    synthetic_strips_per_doc: int = 8   # strips rendered per synthetic doc
                                        # (match the training world)
    corruption: Optional[dict] = None
    random_seed: int = 42
    # the port's addition
    device: str = "cuda"   # torch device; a missing GPU is an error


class EvalPrep:
    def __init__(self, cfg: EvalPrepConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.charmap = CharMap.default()
        backend = get_ocr_helper(cfg.ocr, is_eval=True)
        if backend is None:
            raise ValueError(f"unknown OCR backend {cfg.ocr!r}")
        self.ocr = OcrQueryEngine(backend, self.charmap)

        self.prep_model = UNet(init_features=cfg.unet_features,
                               conv_impl="auto").to(self.device)
        load_checkpoint(cfg.prep_path, self.prep_model)
        self.prep_model.eval()
        # (accuracy, CER) of the OCR on the original images, set by an
        # eval with show_orig
        self.original: Optional[tuple] = None

        is_patch = cfg.dataset in ("patch_dataset", "wildreceipt",
                                   "synthetic_patch")
        if cfg.dataset == "synthetic_patch":
            self.dataset = PatchDocuments.synthetic(
                cfg.synthetic_docs, seed=cfg.random_seed,
                n_strips=cfg.synthetic_strips_per_doc,
                max_strips=cfg.max_strips, corruption=cfg.corruption,
                doc_size=cfg.doc_size)
        elif cfg.dataset == "synthetic_area":
            self.dataset = SyntheticWordDataset(
                cfg.synthetic_size, seed=cfg.random_seed,
                corruption=cfg.corruption)
        elif is_patch:
            split = C.PATCH_TEST if cfg.dataset == "patch_dataset" \
                else C.WR_TEST
            self.dataset = PatchDocuments(
                os.path.join(cfg.data_base_path, split),
                max_strips=cfg.max_strips, doc_size=cfg.doc_size)
        else:
            split = C.VGG_TEXT_TEST if cfg.dataset == "vgg" \
                else C.POS_TEXT_TEST
            self.dataset = ImgDataset(os.path.join(cfg.data_base_path, split))

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.no_grad()
    def _prep_strips(self, images: torch.Tensor, bboxes: torch.Tensor):
        doc_out = self.prep_model(images)
        return doc_out, get_text_stack_batch(doc_out, bboxes)

    @torch.no_grad()
    def _compare(self, pred, pred_len, gt, gt_len, mask):
        return compare_labels_device(self._dev(pred), self._dev(pred_len),
                                     gt, gt_len, mask)

    # ------------------------------------------------------------------
    def _postprocess(self, texts):
        if self.cfg.dataset == "wildreceipt":
            return [t.replace(" ", "") for t in texts]
        return texts

    def _ocr_encoded(self, images: np.ndarray):
        res = self.ocr.query(images)
        texts = self._postprocess(res.texts)
        return self.charmap.encode([self.charmap.clean(t) for t in texts]), texts

    def _padded(self, rows, labs, lens, N, L):
        """OCR labels of the real rows scattered into (N, L) / (N,) arrays
        (pad-filled, zero length elsewhere)."""
        labels = np.full((N, L), self.charmap.pad_id, np.int32)
        lengths = np.zeros((N,), np.int32)
        labels[rows], lengths[rows] = labs, lens
        return labels, lengths

    def eval_patch(self):
        cfg = self.cfg
        D, S = cfg.batch_docs, cfg.max_strips
        L = self.charmap.max_len
        prd_crt = prd_cer = ori_crt = ori_cer = 0.0
        lbl_count = 0
        for batch in batch_iterator(self.dataset, D, collate_docs,
                                    shuffle=False, drop_last=False):
            if batch.images.shape[0] != D:
                # pad the tail with mask-zero docs (fixed shapes) so every
                # document is scored, as the reference's per-doc iteration
                # does (`eval_prep.py:110-175`)
                batch = pad_docbatch(batch, D)
            images = self._dev(batch.images)
            bboxes = self._dev(batch.bboxes)
            N = D * S
            rows = np.nonzero(batch.strip_mask.reshape(N))[0]
            gt = self._dev(batch.gt_labels.reshape(N, L))
            gt_len = self._dev(batch.gt_lengths.reshape(N))
            mask = self._dev(batch.strip_mask.reshape(N))

            if cfg.show_orig:
                orig_strips = get_text_stack_batch(images, bboxes)
                arr = orig_strips.reshape(N, 1, 32, 128).cpu().numpy()[rows]
                (labs, lens), _ = self._ocr_encoded(arr)
                crt, cer, _ = self._compare(
                    *self._padded(rows, labs, lens, N, L), gt, gt_len, mask)
                ori_crt += float(crt); ori_cer += float(cer)

            doc_out, strips = self._prep_strips(images, bboxes)
            arr = strips.reshape(N, 1, 32, 128).cpu().numpy()[rows]
            (labs, lens), texts = self._ocr_encoded(arr)
            if cfg.show_img:
                # headless replacement for the reference's interactive
                # show_img: save cleaned docs + strips as grids
                os.makedirs("eval_out", exist_ok=True)
                save_image_grid(doc_out.cpu().numpy(),
                                f"eval_out/cleaned_docs_{lbl_count}.png",
                                nrow=2)
                save_image_grid(arr, f"eval_out/cleaned_strips_{lbl_count}.png")
            crt, cer, _ = self._compare(
                *self._padded(rows, labs, lens, N, L), gt, gt_len, mask)
            prd_crt += float(crt); prd_cer += float(cer)
            lbl_count += len(rows)
            if cfg.show_txt:
                gts = self.charmap.decode(batch.gt_labels.reshape(N, L)[rows],
                                          batch.gt_lengths.reshape(N)[rows])
                for g, p in zip(gts, texts):
                    print(f"{g!r} -> {p!r}")

        lc = max(1, lbl_count)
        if cfg.show_orig:
            self.original = (ori_crt / lc, ori_cer / lc)
        print(f"Correct count from predicted images: {int(prd_crt)}/{lbl_count} "
              f"({prd_crt / lc:.5f})")
        if cfg.show_orig:
            print(f"Correct count from original images: {int(ori_crt)}/{lbl_count} "
                  f"({ori_crt / lc:.5f})")
            print(f"Average CER from original images: ({ori_cer / lc:.5f})")
        print(f"Average CER from predicted images: ({prd_cer / lc:.5f})")
        return prd_crt / lc, prd_cer / lc

    def eval_area(self):
        cfg = self.cfg
        crt_sum = cer_sum = ori_crt = ori_cer = 0.0
        count = 0
        for batch in batch_iterator(
                self.dataset, cfg.batch_size,
                partial(collate_words, charmap=self.charmap),
                shuffle=False, drop_last=False):
            t = word_batch_to(batch, self.device)
            with torch.no_grad():
                img_out = self.prep_model(t.images).cpu().numpy()
            (labs, lens), _ = self._ocr_encoded(img_out)
            if cfg.show_img and count == 0:
                os.makedirs("eval_out", exist_ok=True)
                save_image_grid(img_out, "eval_out/cleaned_crops.png")
            crt, cer, _ = self._compare(labs, lens, t.labels, t.lengths, None)
            crt_sum += float(crt); cer_sum += float(cer)
            if cfg.show_orig:
                (olabs, olens), _ = self._ocr_encoded(batch.images)
                crt, cer, _ = self._compare(olabs, olens, t.labels, t.lengths,
                                            None)
                ori_crt += float(crt); ori_cer += float(cer)
            count += batch.images.shape[0]
        n = max(1, count)
        print(f"Correct count from predicted images: {int(crt_sum)}/{count} "
              f"({crt_sum / n:.5f})")
        if cfg.show_orig:
            self.original = (ori_crt / n, ori_cer / n)
            print(f"Correct count from original images: {int(ori_crt)}/{count} "
                  f"({ori_crt / n:.5f})")
            print(f"Average CER from original images: {ori_cer / n:.5f}")
        print(f"Average CER from predicted images: {cer_sum / n:.5f}")
        return crt_sum / n, cer_sum / n

    def eval(self):
        if self.cfg.dataset in ("patch_dataset", "wildreceipt",
                                "synthetic_patch"):
            return self.eval_patch()
        return self.eval_area()
