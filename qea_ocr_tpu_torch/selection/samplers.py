"""Query-budget selection strategies (counterpart of
`qea_ocr_tpu/selection/samplers.py`, reference `selection_utils.py:61-229`).

Every per-batch strategy assigns each strip slot a **priority rank**
(0 = selected first); `select_batch` then takes `rank < k_d` with
`k_d = max(1, ceil(n_valid * (1 - prop)))` per document (the budget formula
of `train_nn_patch.py:255-256`). Picking k of n becomes fixed-shape masking,
and nothing here reads a value back to the host, so selection can run on the
device beside the step.

The rank functions take a whole batch, `(D, S)` estimates and validity, where
the JAX package maps a per-document kernel over the batch. Randomness comes
from an explicit `torch.Generator`, or is handed in (`noise`, uniform in
[0, 1), of the estimates' shape), which is how the parity tests feed both
packages the same numbers: `jax.random` streams do not exist here.

Strategies (names as in `selection_utils.py:220-229`):
  * random         - uniform-noise ranks (a randperm prefix)
  * topKCER        - rank by descending CER
  * rangeCER       - uniform points over [min, max] CER; each point claims
                     the nearest unclaimed strip (claimed -> sentinel 100.0,
                     the reference's sentinel)
  * uniformEntropy - rangeCER's kernel over mean CRNN output entropy
  * uniformCERglobal / randomglobal - epoch-level selection over the whole
                     CER table on the host; per batch the mask is membership.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from qea_ocr_tpu_torch.utils.metrics import span

_SENTINEL = 100.0
_BIG_RANK = 10 ** 6


def _noise(generator: torch.Generator | None, like: torch.Tensor,
           noise: torch.Tensor | None) -> torch.Tensor:
    if noise is not None:
        return noise.to(device=like.device, dtype=torch.float32)
    if generator is None:
        raise ValueError("this strategy draws random numbers: give it a "
                         "torch.Generator or the noise itself")
    return torch.rand(like.shape, generator=generator,
                      device=generator.device).to(like.device)


def _ranks_from_scores(scores: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Lower score -> earlier rank, ties by slot; invalid slots get a huge
    rank. scores, valid: (..., S). Returns (..., S) int32."""
    masked = torch.where(valid, scores.float(),
                         torch.full_like(scores, float("inf"),
                                         dtype=torch.float32))
    order = torch.argsort(masked, dim=-1, stable=True)   # slots, best first
    S = scores.shape[-1]
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(S, device=scores.device).expand(
        order.shape))
    return torch.where(valid, ranks, _BIG_RANK).to(torch.int32)


def random_ranks(generator, estimates: torch.Tensor, valid: torch.Tensor,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform random priority (reference RandomSampler, randperm prefix)."""
    return _ranks_from_scores(_noise(generator, estimates, noise), valid)


def topk_cer_ranks(generator, estimates: torch.Tensor, valid: torch.Tensor,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Highest-CER-first (reference TopKCERSampler, argsort descending)."""
    return _ranks_from_scores(-estimates.float(), valid)


def range_ranks(generator, estimates: torch.Tensor, valid: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """CER-range-coverage priority (reference CerRangeSampler).

    Draws S uniform points in [min, max] of each document's valid estimates;
    point i claims the nearest unclaimed slot (claimed slots become the
    sentinel 100.0, keeping the reference's re-claimable-near-100 quirk). The
    S picks are a serial loop, each a handful of device ops over all
    documents at once, with no host read. A slot claimed twice (its estimate
    *is* the sentinel after the first claim, so a later point near 100 takes
    it again, which shrinks the picked set as in `selection_utils.py:127-134`)
    keeps its first, best rank: the scatter combines with `amin`."""
    est = estimates.float()
    lead, S = est.shape[:-1], est.shape[-1]
    inf = torch.full_like(est, float("inf"))
    lo = torch.where(valid, est, inf).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, est, -inf).amax(dim=-1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    points = lo + (hi - lo) * _noise(generator, est, noise)
    est_c = torch.where(valid, est, inf)
    claimed = torch.empty(lead + (S,), dtype=torch.long, device=est.device)
    for i in range(S):
        idx = (points[..., i:i + 1] - est_c).abs().argmin(dim=-1,
                                                          keepdim=True)
        est_c = est_c.scatter(-1, idx, _SENTINEL)
        claimed[..., i:i + 1] = idx
    ranks = torch.full(lead + (S,), _BIG_RANK, dtype=torch.long,
                       device=est.device)
    ranks = ranks.scatter_reduce(
        -1, claimed, torch.arange(S, device=est.device).expand(claimed.shape),
        reduce="amin")
    return torch.where(valid, ranks, _BIG_RANK).to(torch.int32)


RANK_KERNELS: Dict[str, Callable] = {
    "random": random_ranks,
    "topKCER": topk_cer_ranks,
    "rangeCER": range_ranks,
    "uniformEntropy": range_ranks,   # same kernel; estimates = entropies
}


def select_batch(method: str, generator: torch.Generator | None,
                 estimates: torch.Tensor, valid: torch.Tensor, prop: float,
                 noise: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-document budget selection for a batch of documents.

      estimates: (D, S) per-strip CER (or entropy) estimates.
      valid: (D, S) bool strip-slot validity.
      prop: fraction of samples NOT to query (minibatch_subset_prop).

    Returns bb_mask (D, S) bool, the strips that query the black box this
    step, and k (D,) int32, the per-document query count
    max(1, ceil(n_valid * (1 - prop))), at most n_valid."""
    with span("select"):
        ranks = RANK_KERNELS[method](generator, estimates, valid, noise)
        n_valid = valid.sum(dim=1).float()
        k = torch.ceil(n_valid * (1.0 - prop)).clamp(min=1).to(torch.int32)
        k = torch.minimum(k, n_valid.to(torch.int32))
        k = torch.maximum(k, (n_valid > 0).to(torch.int32))
        return ranks < k[:, None], k


def membership_mask(strip_ids: torch.Tensor,
                    member_bitmap: torch.Tensor) -> torch.Tensor:
    """Global-selection batch mask: a strip is selected iff its stable id is
    in the epoch's member set (reference Uniform/RandomSamplerGlobal.query
    intersects batch names with `selected_samplenames`)."""
    return member_bitmap[strip_ids.long()]


# ---------------------------------------------------------------------------
# Epoch-level (global) selection over the full CER table: host side, once per
# epoch like the reference's `select_samples()` (`train_nn_patch.py:206-209`).
# Numpy, and bit for bit the JAX package's.
# ---------------------------------------------------------------------------
def select_global_uniform(rng: np.random.Generator, cers: np.ndarray,
                          num_samples: int) -> np.ndarray:
    """Quantile-bucketed global pick: sort all CERs, split into num_samples
    buckets, pick one uniformly per bucket. Returns a bool member bitmap.
    With more buckets than strips the empty buckets pick nothing, so the
    bitmap then holds fewer than `num_samples` members and the epoch's query
    ledger is that much under its budget."""
    n = cers.shape[0]
    bitmap = np.zeros(n, dtype=bool)
    order = np.argsort(cers)
    for split in np.array_split(order, max(1, num_samples)):
        if split.size:
            bitmap[rng.choice(split)] = True
    return bitmap


def select_global_random(rng: np.random.Generator, cers: np.ndarray,
                         num_samples: int) -> np.ndarray:
    """Plain global random sample of strip ids. Returns a bool bitmap."""
    n = cers.shape[0]
    bitmap = np.zeros(n, dtype=bool)
    chosen = rng.choice(n, size=min(num_samples, n), replace=False)
    bitmap[chosen] = True
    return bitmap


GLOBAL_METHODS = {
    "uniformCERglobal": select_global_uniform,
    "randomglobal": select_global_random,
}

ALL_METHODS = tuple(RANK_KERNELS) + tuple(GLOBAL_METHODS)


def is_global(method: str | None) -> bool:
    """The reference checks `"global" in selection_method`
    (`train_nn_patch.py:206-208`)."""
    return bool(method) and "global" in method
