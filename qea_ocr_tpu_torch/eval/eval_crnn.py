"""CRNN proxy evaluation: decoded predictions vs GT (proxy quality), with an
optional black-box-OCR-on-original comparison (counterpart of
`qea_ocr_tpu/eval/eval_crnn.py`).

Counterpart of reference `eval_crnn.py:14-207` (`eval_area` for word crops,
`eval_patch` for documents). Strip extraction (the gather kernel on a CUDA
device), decode and CER run on the device; the OCR baseline is a host call
per batch.
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
from qea_ocr_tpu_torch.models.crnn import CRNN
from qea_ocr_tpu_torch.ocr.base import get_ocr_helper
from qea_ocr_tpu_torch.ocr.engine import OcrQueryEngine
from qea_ocr_tpu_torch.ops.ctc import greedy_decode
from qea_ocr_tpu_torch.ops.edit_distance import compare_labels_device
from qea_ocr_tpu_torch.ops.text_stack import get_text_stack_batch
from qea_ocr_tpu_torch.utils.charmap import CharMap
from qea_ocr_tpu_torch.utils.device import resolve_device
from qea_ocr_tpu_torch.utils.io import load_checkpoint


@dataclasses.dataclass
class EvalCrnnConfig:
    crnn_path: str = "."
    crnn_model_name: str = "CRNN_model"
    dataset: str = "pos_textarea"       # vgg | pos | pos_textarea | synthetic*
    ocr: str = "Tesseract"
    batch_size: int = 64
    data_base_path: str = "."
    show_orig: bool = False
    show_txt: bool = False
    show_img: bool = False
    lstm_hidden: int = 256
    batch_docs: int = 2
    max_strips: int = 32
    doc_size: tuple = C.DOC_SIZE
    synthetic_size: int = 64
    synthetic_docs: int = 8
    corruption: Optional[dict] = None
    random_seed: int = 42
    # the port's addition
    device: str = "cuda"   # torch device; a missing GPU is an error


class EvalCRNN:
    def __init__(self, cfg: EvalCrnnConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.charmap = CharMap.default()
        backend = get_ocr_helper(cfg.ocr, is_eval=True)
        self.ocr = OcrQueryEngine(backend, self.charmap) if backend else None

        self.crnn_model = CRNN(self.charmap.vocab_size,
                               lstm_hidden=cfg.lstm_hidden).to(self.device)
        load_checkpoint(os.path.join(cfg.crnn_path, cfg.crnn_model_name),
                        self.crnn_model)
        self.crnn_model.eval()

        if cfg.dataset == "synthetic_patch":
            self.dataset = PatchDocuments.synthetic(
                cfg.synthetic_docs, seed=cfg.random_seed,
                max_strips=cfg.max_strips, corruption=cfg.corruption,
                doc_size=cfg.doc_size)
        elif cfg.dataset == "synthetic_area":
            self.dataset = SyntheticWordDataset(
                cfg.synthetic_size, seed=cfg.random_seed,
                corruption=cfg.corruption)
        elif cfg.dataset == "pos":
            self.dataset = PatchDocuments(
                os.path.join(cfg.data_base_path, C.PATCH_TEST),
                max_strips=cfg.max_strips, doc_size=cfg.doc_size)
        else:
            split = (C.VGG_TEXT_TEST if cfg.dataset == "vgg"
                     else C.POS_TEXT_TEST)
            self.dataset = ImgDataset(os.path.join(cfg.data_base_path, split))

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.no_grad()
    def _decode(self, images: torch.Tensor):
        scores = self.crnn_model(images)
        return greedy_decode(scores, pad_id=self.charmap.pad_id)

    def eval_area(self):
        cfg = self.cfg
        L = self.charmap.max_len
        crnn_crt = crnn_cer = ori_crt = ori_cer = 0.0
        count = 0
        for batch in batch_iterator(
                self.dataset, cfg.batch_size,
                partial(collate_words, charmap=self.charmap),
                shuffle=False, drop_last=False):
            t = word_batch_to(batch, self.device)
            dec, dec_len = self._decode(t.images)
            crt, cer, _ = compare_labels_device(
                dec[:, :L], dec_len.clamp(max=L), t.labels, t.lengths, None)
            crnn_crt += float(crt); crnn_cer += float(cer)
            if cfg.show_orig and self.ocr:
                res = self.ocr.query(batch.images)
                crt, cer, _ = compare_labels_device(
                    self._dev(res.labels), self._dev(res.lengths),
                    t.labels, t.lengths, None)
                ori_crt += float(crt); ori_cer += float(cer)
            if cfg.show_txt:
                preds = self.charmap.decode(dec.cpu().numpy(),
                                            dec_len.cpu().numpy())
                for g, p in zip(batch.texts, preds):
                    print(f"{g!r} -> {p!r}")
            count += batch.images.shape[0]
        n = max(1, count)
        print(f"Correct count from CRNN: {int(crnn_crt)}/{count} "
              f"({crnn_crt / n:.5f})")
        print(f"Average CER from CRNN: {crnn_cer / n:.5f}")
        if cfg.show_orig:
            print(f"Correct count from {cfg.ocr}: {int(ori_crt)}/{count} "
                  f"({ori_crt / n:.5f})")
        return crnn_crt / n, crnn_cer / n

    def eval_patch(self):
        cfg = self.cfg
        D, S = cfg.batch_docs, cfg.max_strips
        L = self.charmap.max_len
        crnn_crt = crnn_cer = ori_crt = ori_cer = 0.0
        lbl_count = 0
        for batch in batch_iterator(self.dataset, D, collate_docs,
                                    shuffle=False, drop_last=False):
            if batch.images.shape[0] != D:
                # pad the tail with mask-zero docs (fixed shapes) so every
                # document is scored (reference `eval_crnn.py:110+`)
                batch = pad_docbatch(batch, D)
            N = D * S
            strips = get_text_stack_batch(
                self._dev(batch.images), self._dev(batch.bboxes))
            strips = strips.reshape(N, 1, *C.INPUT_SIZE)
            dec, dec_len = self._decode(strips)
            rows = np.nonzero(batch.strip_mask.reshape(N))[0]
            mask = self._dev(batch.strip_mask.reshape(N))
            gt = self._dev(batch.gt_labels.reshape(N, L))
            gt_len = self._dev(batch.gt_lengths.reshape(N))
            crt, cer, _ = compare_labels_device(
                dec[:, :L], dec_len.clamp(max=L), gt, gt_len, mask)
            crnn_crt += float(crt); crnn_cer += float(cer)
            if cfg.show_orig and self.ocr:
                res = self.ocr.query(strips.cpu().numpy()[rows])
                o_labels = np.full((N, L), self.charmap.pad_id, np.int32)
                o_lengths = np.zeros((N,), np.int32)
                o_labels[rows], o_lengths[rows] = res.labels, res.lengths
                crt, cer, _ = compare_labels_device(
                    self._dev(o_labels), self._dev(o_lengths),
                    gt, gt_len, mask)
                ori_crt += float(crt); ori_cer += float(cer)
            lbl_count += len(rows)
        lc = max(1, lbl_count)
        print(f"Correct count from CRNN: {int(crnn_crt)}/{lbl_count} "
              f"({crnn_crt / lc:.5f})")
        print(f"Average CER from CRNN: {crnn_cer / lc:.5f}")
        return crnn_crt / lc, crnn_cer / lc

    def eval(self):
        if self.cfg.dataset in ("pos", "synthetic_patch"):
            return self.eval_patch()
        return self.eval_area()
