"""Host batching of the port's data path, and the host-to-device step.

`DocBatch`, `collate_docs`, `pad_docbatch`, `blank_docbatch`,
`batch_iterator` (thread-pool sample fetch, background prefetch) and
`default_num_workers` are the port's own copy of the document half of
`qea_ocr_tpu/data/pipeline.py` (numpy only): documents, boxes and labels are
assembled on the host into fixed-shape arrays, all raggedness resolved at
dataset construction. The word batches and the multi-host sharding wait for
their slices. `doc_batch_to` moves a collated `DocBatch` onto a torch
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

from qea_ocr_tpu_torch.data.datasets import DocSample


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

    `host_shard=(process_index, process_count)` is the JAX package's
    multi-host sharding; it waits for the port's parallel slice and raises.

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
        raise NotImplementedError(
            "host_shard: multi-process data sharding is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
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
