"""Host batching of the port's data path, and the host-to-device step.

The word batches (`WordBatch`, `collate_words`, `pad_wordbatch`,
`blank_wordbatch`), the document batches (`DocBatch`, `collate_docs`,
`pad_docbatch`, `blank_docbatch`), `batch_iterator` (thread-pool sample
fetch, background prefetch) and `default_num_workers` are the port's own
copy of `qea_ocr_tpu/data/pipeline.py` (numpy only): crops, documents, boxes
and labels are assembled on the host into fixed-shape arrays, all raggedness
resolved at dataset construction, and `host_shard` cuts a process's rows
out of every global batch. `doc_batch_to` and `word_batch_to` move a collated batch onto a torch
device.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from qea_ocr_tpu_torch.data.datasets import DocSample, WordSample
from qea_ocr_tpu_torch.utils.charmap import CharMap


@dataclasses.dataclass
class WordBatch:
    images: np.ndarray       # (B, 1, H, W) float32
    labels: np.ndarray       # (B, L) int32
    lengths: np.ndarray      # (B,) int32
    strip_ids: np.ndarray    # (B,) int32
    texts: List[str]
    names: List[str]


@dataclasses.dataclass
class DocBatch:
    images: np.ndarray       # (D, 1, H, W) float32
    bboxes: np.ndarray       # (D, S, 4) int32
    strip_mask: np.ndarray   # (D, S) bool
    gt_labels: np.ndarray    # (D, S, L) int32
    gt_lengths: np.ndarray   # (D, S) int32
    strip_ids: np.ndarray    # (D, S) int32
    strip_names: List[List[str]]
    doc_names: List[str]


def collate_words(samples: Sequence[WordSample], charmap: CharMap) -> WordBatch:
    imgs = np.stack([s.image for s in samples])[:, None]
    texts = [charmap.clean(s.label) for s in samples]
    labels, lengths = charmap.encode(texts)
    ids = np.asarray([s.strip_id for s in samples], np.int32)
    return WordBatch(imgs.astype(np.float32), labels, lengths, ids,
                     texts, [s.name for s in samples])


def collate_docs(samples: Sequence[DocSample]) -> DocBatch:
    return DocBatch(
        images=np.stack([s.image for s in samples])[:, None].astype(np.float32),
        bboxes=np.stack([s.bboxes for s in samples]),
        strip_mask=np.stack([s.strip_mask for s in samples]),
        gt_labels=np.stack([s.gt_labels for s in samples]),
        gt_lengths=np.stack([s.gt_lengths for s in samples]),
        strip_ids=np.stack([s.strip_ids for s in samples]),
        strip_names=[s.strip_names for s in samples],
        doc_names=[s.doc_name for s in samples],
    )


def pad_wordbatch(batch: WordBatch, B: int) -> WordBatch:
    """Pad a tail word batch up to `B` samples so fixed-shape steps accept
    it; callers mask out the padding rows (`arange(B) < real`). Padding
    rows are white images with zero-length labels, mirroring
    `pad_docbatch` (the reference iterates every val sample,
    `train_nn_area.py:327-345`)."""
    b = batch.images.shape[0]
    if b >= B:
        return batch
    pad = B - b

    def _z(a, fill=0):
        ext = np.full((pad, *a.shape[1:]), fill, a.dtype)
        return np.concatenate([a, ext], axis=0)

    return WordBatch(
        images=_z(batch.images, fill=1.0),
        labels=_z(batch.labels),
        lengths=_z(batch.lengths),
        strip_ids=_z(batch.strip_ids),
        texts=batch.texts + [""] * pad,
        names=batch.names + [""] * pad,
    )


def pad_docbatch(batch: DocBatch, D: int) -> DocBatch:
    """Pad a tail batch up to `D` documents with mask-zero padding docs.

    The step functions take a static (D, S, ...) shape; rather than
    dropping tail batches (which would silently skip validation documents),
    the tail is padded with all-False `strip_mask` docs that every masked
    reduction ignores.
    """
    d = batch.images.shape[0]
    if d >= D:
        return batch
    pad = D - d

    def _z(a):
        return np.concatenate(
            [a, np.zeros((pad, *a.shape[1:]), a.dtype)], axis=0)

    return DocBatch(
        images=_z(batch.images),
        bboxes=_z(batch.bboxes),
        strip_mask=_z(batch.strip_mask),
        gt_labels=_z(batch.gt_labels),
        gt_lengths=_z(batch.gt_lengths),
        strip_ids=_z(batch.strip_ids),
        strip_names=batch.strip_names + [[] for _ in range(pad)],
        doc_names=batch.doc_names + [""] * pad,
    )


def blank_wordbatch(like: WordBatch, B: int) -> WordBatch:
    """An all-padding word batch with `like`'s per-row shapes: B white
    images with zero-length labels (counterpart of `blank_docbatch`)."""

    def _z(a, fill=0):
        return np.full((B, *a.shape[1:]), fill, a.dtype)

    return WordBatch(
        images=_z(like.images, 1.0), labels=_z(like.labels),
        lengths=_z(like.lengths), strip_ids=_z(like.strip_ids),
        texts=[""] * B, names=[""] * B)


def blank_docbatch(like: DocBatch, D: int) -> DocBatch:
    """An all-padding batch with `like`'s per-doc shapes: D mask-zero docs.
    The JAX package feeds it to hosts whose slice of a validation window
    is empty; here it is the shape-preserving blank of a batch."""

    def _z(a):
        return np.zeros((D, *a.shape[1:]), a.dtype)

    return DocBatch(
        images=_z(like.images), bboxes=_z(like.bboxes),
        strip_mask=_z(like.strip_mask), gt_labels=_z(like.gt_labels),
        gt_lengths=_z(like.gt_lengths), strip_ids=_z(like.strip_ids),
        strip_names=[[] for _ in range(D)], doc_names=[""] * D)


def batch_iterator(
    dataset,
    batch_size: int,
    collate_fn,
    *,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
    indices: Optional[np.ndarray] = None,
    num_workers: int = 0,
    prefetch: int = 0,
    host_shard: Optional[tuple] = None,
) -> Iterator:
    """Shuffled fixed-size batches; optional index subset (pruning /
    image_prop subsampling parity with SubsetRandomSampler usage).

    `host_shard=(process_index, process_count)` yields only this process's
    rows of every global batch (`parallel.multihost.shard_indices_for_host`):
    the shuffle is the same on every process, `batch_size` is the global
    batch and each batch holds `batch_size / process_count` rows.

    `num_workers > 0` fetches the samples of a batch through a thread pool
    (the counterpart of torch DataLoader workers, `properties.py:34`: PNG
    decode in PIL releases the GIL; for OCRDataset the black-box call also
    runs in the worker, matching reference `datasets/ocr_dataset.py:40`).
    `prefetch > 0` assembles up to that many batches ahead on a background
    thread so the host pipeline overlaps device steps.
    """
    if indices is None:
        indices = np.arange(len(dataset))
    indices = np.asarray(indices)
    if shuffle:
        rng = np.random.default_rng(seed + epoch)
        indices = rng.permutation(indices)
    if host_shard is not None:
        from qea_ocr_tpu_torch.parallel.multihost import (
            shard_indices_for_host)
        pi, pc = host_shard
        indices = shard_indices_for_host(indices, batch_size, pi, pc)
        batch_size //= pc
        drop_last = True  # lockstep across hosts; shard already windowed
    n = len(indices)
    end = n - (n % batch_size) if drop_last else n

    def chunks():
        for start in range(0, end, batch_size):
            chunk = indices[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield chunk

    if num_workers > 0:
        pool = ThreadPoolExecutor(max_workers=num_workers)

        def produce():
            for chunk in chunks():
                samples = list(pool.map(
                    lambda i: dataset[int(i)], chunk))
                yield collate_fn(samples)
        it = produce()
    else:
        it = (collate_fn([dataset[int(i)] for i in chunk])
              for chunk in chunks())
    try:
        if prefetch > 0:
            yield from prefetch_iterator(it, depth=prefetch)
        else:
            yield from it
    finally:
        if num_workers > 0:
            pool.shutdown(wait=False)


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` on a background thread, keeping up to `depth` items ready.

    Exceptions from the producer re-raise at the consumer's next pull. If
    the consumer abandons the iterator (break / exception in the batch
    loop), the producer notices via a stop flag and exits instead of
    blocking forever on the bounded queue with pinned batches.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not _put((None, item)):
                    return
        except BaseException as e:  # noqa: BLE001, forwarded to consumer
            _put((e, None))
            return
        _put((None, done))

    t = threading.Thread(target=producer, daemon=True, name="qea-prefetch")
    t.start()
    try:
        while True:
            # Bounded wait + liveness check: a producer torn down without
            # posting done/error (e.g. interpreter shutdown) must surface
            # as an exception, not a consumer hang on q.get().
            while True:
                try:
                    err, item = q.get(timeout=5.0)
                    break
                except queue.Empty:
                    if not t.is_alive():
                        try:  # drain a final item racing the liveness check
                            err, item = q.get_nowait()
                            break
                        except queue.Empty:
                            raise RuntimeError(
                                "prefetch producer thread died without "
                                "signalling completion") from None
            if err is not None:
                raise err
            if item is done:
                return
            yield item
    finally:
        stop.set()


def default_num_workers() -> int:
    """Reference `properties.py:34` ships num_workers=4; QEA_NUM_WORKERS
    overrides (0 = synchronous in-thread fetch)."""
    return int(os.environ.get("QEA_NUM_WORKERS", "4"))


@dataclasses.dataclass
class DocTensors:
    """The arrays of a `DocBatch` that the step functions take, as tensors
    on one device."""
    images: torch.Tensor       # (D, 1, H, W) float32
    bboxes: torch.Tensor       # (D, S, 4) int32
    strip_mask: torch.Tensor   # (D, S) bool
    gt_labels: torch.Tensor    # (D, S, L) int32
    gt_lengths: torch.Tensor   # (D, S) int32
    strip_ids: torch.Tensor    # (D, S) int32


def doc_batch_to(batch: DocBatch, device: torch.device) -> DocTensors:
    """Copy `batch`'s arrays to `device`."""
    return DocTensors(**{
        f.name: torch.from_numpy(getattr(batch, f.name)).to(device)
        for f in dataclasses.fields(DocTensors)})


@dataclasses.dataclass
class WordTensors:
    """The arrays of a `WordBatch` that the CRNN steps take, as tensors on
    one device."""
    images: torch.Tensor       # (B, 1, H, W) float32
    labels: torch.Tensor       # (B, L) int32
    lengths: torch.Tensor      # (B,) int32


def word_batch_to(batch: WordBatch, device: torch.device) -> WordTensors:
    """Copy `batch`'s arrays to `device`."""
    return WordTensors(**{
        f.name: torch.from_numpy(getattr(batch, f.name)).to(device)
        for f in dataclasses.fields(WordTensors)})
