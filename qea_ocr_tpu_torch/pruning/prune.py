"""Dataset pruning: keep the most useful documents by CER.

Counterpart of reference `pruning/prune_dataset.py:28-115` +
`pruning/methods.py:5-22`:
  * mean CER per document from a strip-level CER JSON;
  * `topk`: keep the num_samples highest-mean-CER documents;
  * `facility_location`: diverse subset via greedy facility-location
    submodular maximization (the reference uses apricot's optimizer; this is
    a self-contained greedy over a 1-D similarity kernel — no numba dep);
  * JSON artifact save/load; `pruning_indices` filters a PatchDocuments
    dataset to the pruned set at train time (reference `get_pruning_sampler`,
    `utils.py:246-263`, hooked at `train_nn_patch.py:119-120`).

The port's own copy of `qea_ocr_tpu/pruning/prune.py` (numpy only): the
port imports nothing of the JAX package, and `tests/test_torch_tooling.py`
holds the copy equal to its original, but for one repair in
`pruning_indices` (its docstring).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict

import numpy as np


def doc_mean_cers(strip_cers: Dict[str, float]) -> Dict[str, float]:
    """Group strip CERs ('{j}_{label}_{folder}_{file}') per document
    '{folder}_{file}' and average."""
    groups = defaultdict(list)
    for name, cer in strip_cers.items():
        parts = name.split("_")
        doc = "_".join(parts[-2:]) if len(parts) >= 2 else name
        groups[doc].append(float(cer))
    return {doc: float(np.mean(v)) for doc, v in groups.items()}


def topk(cer_means: Dict[str, float], num_samples: int) -> Dict[str, float]:
    items = sorted(cer_means.items(), key=lambda kv: kv[1], reverse=True)
    return dict(items[:num_samples])


def facility_location(cer_means: Dict[str, float],
                      num_samples: int) -> Dict[str, float]:
    """Greedy facility-location on the 1-D CER feature: maximize
    sum_j max_{i in S} sim(i, j) with sim = max_pairwise_dist - |c_i - c_j|."""
    names = list(cer_means.keys())
    x = np.asarray([cer_means[n] for n in names], np.float64)
    if num_samples >= len(x):
        return dict(cer_means)
    # OpenMP C++ greedy when the native lib is available (the reference
    # leans on apricot's numba kernels here); numpy greedy otherwise. Both
    # run the same greedy with first-index tie-breaking, but exact float64
    # gain ties can resolve differently (summation order), so the guarantee
    # across implementations is equal OBJECTIVE value, not identical
    # indices (tests/test_native.py).
    from qea_ocr_tpu_torch.utils.native import facility_location_indices
    chosen = facility_location_indices(x, num_samples)
    return {names[i]: float(x[i]) for i in chosen}


PRUNING_METHODS = {"topk": topk, "FL": facility_location}


class DatasetPruner:
    """Builds + saves a pruning artifact (reference `DatasetPruner`)."""

    def __init__(self, strip_cers: Dict[str, float], method: str,
                 num_samples: int):
        self.cer_means = doc_mean_cers(strip_cers)
        self.method = method
        self.num_samples = num_samples

    def prune(self) -> Dict[str, float]:
        return PRUNING_METHODS[self.method](self.cer_means, self.num_samples)

    def save(self, out_dir: str, artifact_name: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{artifact_name}.json")
        with open(path, "w") as f:
            json.dump(self.prune(), f)
        return path


def load_artifact(artifact: str) -> Dict[str, float]:
    """Artifact may be a JSON path or a name under pruning/cer_artifacts/."""
    if os.path.exists(artifact):
        path = artifact
    else:
        path = os.path.join("pruning", "cer_artifacts", f"{artifact}.json")
    with open(path) as f:
        return json.load(f)


def pruning_indices(dataset, artifact: str) -> np.ndarray:
    """Indices of dataset documents whose '{folder}_{file}' key is in the
    artifact (reference `get_pruning_sampler` filter), or the key
    `doc_mean_cers` groups the document's strips under: its last two '_'
    fields. The two differ where a folder or file name holds a '_' (the
    synthetic `synth/doc_00003`, grouped as `doc_00003`); the JAX package
    matches the first only, so an artifact made from such documents keeps
    none of them there."""
    pruned = load_artifact(artifact)
    keep = []
    for i, sample in enumerate(dataset.samples):
        folder_file = sample.doc_name.replace(os.sep, "_")
        grouped = "_".join(folder_file.split("_")[-2:])
        if folder_file in pruned or grouped in pruned:
            keep.append(i)
    return np.asarray(keep, dtype=np.int64)
