"""Host-facing sampler API with reference-shaped classes (counterpart of
`qea_ocr_tpu/selection/api.py`).

Mirrors the `DataSampler` class surface of `selection_utils.py:61-229`
(`query(images, labels, num_samples, names)` / `update_cer`) for users
migrating from the reference, while delegating the math to the rank
functions in `qea_ocr_tpu_torch.selection.samplers`. The trainers do not go
through these classes: they call `select_batch` on the batch's tables.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from qea_ocr_tpu_torch.selection import samplers as S


class DataSampler:
    """Base: CER bookkeeping identical in contract to the reference
    (`update_cer` overwrites latest CER and appends to `all_cers` history)."""

    method: str = "random"

    def __init__(self, cers: Dict[str, float] | None = None, *_args, **_kw):
        self.cers: Dict[str, float] = dict(cers) if cers else {}
        self.all_cers: Dict[str, List[float]] = {}
        self._rng = np.random.default_rng(0)
        self._gen = torch.Generator().manual_seed(0)

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)

    def _estimates_for(self, names: Sequence[str]) -> np.ndarray:
        # Strips never seen get CER 1.0 (pessimistic): a deviation from the
        # reference, which silently drops unseen names and then misindexes
        # (`selection_utils.py:121-123`).
        return np.asarray([self.cers.get(n, 1.0) for n in names], np.float32)

    def update_cer(self, batch_cers: Sequence[float], names: Sequence[str]) -> None:
        for name, cer in zip(names, batch_cers):
            self.cers[name] = float(cer)
            self.all_cers.setdefault(name, []).append(float(cer))

    def _select(self, estimates: np.ndarray, num_samples: int) -> np.ndarray:
        valid = np.ones(estimates.shape[0], bool)
        bb_mask, _ = S.select_batch(
            self.method, self._gen,
            torch.from_numpy(estimates[None]), torch.from_numpy(valid[None]),
            1.0 - num_samples / max(1, estimates.shape[0]),
        )
        ranks_sel = np.nonzero(bb_mask[0].numpy())[0]
        return ranks_sel[:num_samples]

    def query(self, images, labels, num_samples: int, names: Sequence[str] | None = None):
        estimates = self._estimates_for(names) if names is not None else \
            self._rng.random(len(labels)).astype(np.float32)
        idx = self._select(estimates, num_samples)
        images = np.asarray(images)
        return images[idx], [labels[i] for i in idx], idx


class RandomSampler(DataSampler):
    method = "random"

    def query(self, images, labels, num_samples, names=None):
        images = np.asarray(images)
        idx = self._rng.permutation(images.shape[0])[:num_samples]
        return images[idx], [labels[i] for i in idx], idx


class TopKCERSampler(DataSampler):
    method = "topKCER"

    def __init__(self, cers=None, discount_factor: float = 1.0):
        super().__init__(cers)
        self.discount_factor = discount_factor

    def query(self, images, labels, num_samples, names):
        est = self._estimates_for(names)
        idx = np.argsort(-est, kind="stable")[:num_samples]
        images = np.asarray(images)
        return images[idx], [labels[i] for i in idx], idx


class CerRangeSampler(DataSampler):
    method = "rangeCER"

    def __init__(self, cers=None, discount_factor: float = 1.0):
        super().__init__(cers)
        self.discount_factor = discount_factor

    def query(self, images, labels, num_samples, names):
        est = self._estimates_for(names)
        idx = _nearest_point_selection(self._rng, est, num_samples)
        images = np.asarray(images)
        return images[idx], [labels[i] for i in idx], idx


class UniformEntropySampler(DataSampler):
    method = "uniformEntropy"

    def __init__(self, entropies=None, cers=None):
        super().__init__(cers)
        self.entropies: Dict[str, float] = dict(entropies) if entropies else {}

    def update_entropies(self, ents: Sequence[float], names: Sequence[str]) -> None:
        for e, n in zip(ents, names):
            self.entropies[n] = float(e)

    def query(self, images, labels, num_samples, names):
        est = np.asarray([self.entropies.get(n, 1.0) for n in names], np.float32)
        idx = _nearest_point_selection(self._rng, est, num_samples)
        images = np.asarray(images)
        return images[idx], [labels[i] for i in idx], idx


class _GlobalSampler(DataSampler):
    _global_fn = None

    def __init__(self, cers=None, num_samples: int | None = None):
        super().__init__(cers)
        self.num_samples = num_samples or 1
        self.selected_samplenames: Dict[str, bool] = {}

    def select_samples(self) -> None:
        names = list(self.cers.keys())
        cer_values = np.asarray([self.cers[n] for n in names], np.float32)
        bitmap = type(self)._global_fn(self._rng, cer_values, self.num_samples)
        self.selected_samplenames = {names[i]: True for i in np.nonzero(bitmap)[0]}

    def query(self, images, labels, num_samples=-1, names=None):
        idx = np.asarray(
            [i for i, n in enumerate(names) if n in self.selected_samplenames],
            dtype=np.int64,
        )
        images = np.asarray(images)
        return images[idx], [labels[i] for i in idx], idx


class UniformSamplerGlobal(_GlobalSampler):
    method = "uniformCERglobal"
    _global_fn = staticmethod(S.select_global_uniform)


class RandomSamplerGlobal(_GlobalSampler):
    method = "randomglobal"
    _global_fn = staticmethod(S.select_global_random)


def _nearest_point_selection(
    rng: np.random.Generator, estimates: np.ndarray, num_samples: int
) -> np.ndarray:
    """Host-side nearest-unclaimed-point loop (sentinel 100, reference
    `selection_utils.py:124-134`)."""
    if estimates.size == 0:
        return np.zeros((0,), np.int64)
    lo, hi = float(estimates.min()), float(estimates.max())
    points = lo + (hi - lo) * rng.random(num_samples)
    est = estimates.astype(np.float64).copy()
    out = np.zeros(num_samples, np.int64)
    for i, p in enumerate(points):
        idx = int(np.argmin(np.abs(p - est)))
        out[i] = idx
        est[idx] = 100.0
    return out


def datasampler_factory(sampling_method: str):
    """Name -> sampler class. Key parity with `selection_utils.py:220-229`."""
    mapping = {
        "random": RandomSampler,
        "topKCER": TopKCERSampler,
        "uniformCERglobal": UniformSamplerGlobal,
        "randomglobal": RandomSamplerGlobal,
        "rangeCER": CerRangeSampler,
        "uniformEntropy": UniformEntropySampler,
    }
    return mapping[sampling_method]
