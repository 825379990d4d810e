"""Label-history tracking as a fixed-shape ring buffer (the port's own copy
of `qea_ocr_tpu/tracking/history.py`, numpy only;
`tests/test_torch_tracking.py` holds the two equal).

Counterpart of the reference's `tracked_labels` dict-of-lists
(`tracking_utils.py:77-81`) and `generate_ctc_target_batches`
(`tracking_utils.py:42-56`). The reference stores unbounded python string
lists per strip and rebuilds ragged CTC target batches per depth each step;
here history lives as dense int arrays keyed by stable strip ids:

    labels  (num_strips, window, max_len) int32, slot 0 = most recent
    lengths (num_strips, window)          int32
    counts  (num_strips,)                 int32  (total labels ever seen)

so the trainer gathers `(B, window, L)` target tensors with one indexed
read and the weighted CTC runs as one batched device loss. A host-side text
mirror keeps the reference's JSON checkpoint format
(`tracked_labels_{epoch}.json`, `utils.py:215-224`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from qea_ocr_tpu_torch.utils.charmap import CharMap


class LabelHistory:
    def __init__(
        self,
        num_strips: int,
        window_size: int,
        charmap: CharMap | None = None,
        keep_text_mirror: bool = True,
    ):
        self.window = window_size
        self.charmap = charmap or CharMap.default()
        L = self.charmap.max_len
        self.labels = np.full(
            (num_strips, window_size, L), self.charmap.pad_id, np.int32
        )
        self.lengths = np.zeros((num_strips, window_size), np.int32)
        self.counts = np.zeros((num_strips,), np.int32)
        self.keep_text_mirror = keep_text_mirror
        self.text_mirror: Dict[int, List[str]] = {}

    @property
    def num_strips(self) -> int:
        return self.labels.shape[0]

    def add(
        self,
        ids: np.ndarray,
        labels: np.ndarray,
        lengths: np.ndarray,
        texts: Sequence[str] | None = None,
    ) -> None:
        """Push one new OCR label per strip id (most-recent-first ring).

        Args:
          ids: (B,) int strip ids.
          labels: (B, max_len) int32 encoded labels.
          lengths: (B,) int32.
        """
        ids = np.asarray(ids)
        # shift right: slot i -> i+1, newest into slot 0
        self.labels[ids, 1:] = self.labels[ids, :-1]
        self.lengths[ids, 1:] = self.lengths[ids, :-1]
        self.labels[ids, 0] = labels
        self.lengths[ids, 0] = lengths
        self.counts[ids] += 1
        if self.keep_text_mirror and texts is not None:
            for i, sid in enumerate(ids.tolist()):
                self.text_mirror.setdefault(sid, []).append(texts[i])

    def gather(self, ids: np.ndarray):
        """-> (labels (B,W,L), lengths (B,W), valid (B,W) bool)."""
        ids = np.asarray(ids)
        labs = self.labels[ids]
        lens = self.lengths[ids]
        depth = np.arange(self.window)[None, :]
        valid = depth < np.minimum(self.counts[ids], self.window)[:, None]
        return labs, lens, valid

    # ------------------------------------------------------------ JSON I/O
    def to_json_dict(self, id_to_name: Dict[int, str]) -> Dict[str, List[str]]:
        """Reference-format tracked-labels dict {strip_name: [labels...]}."""
        return {
            id_to_name[sid]: texts for sid, texts in sorted(self.text_mirror.items())
        }

    def save_json(self, path: str, id_to_name: Dict[int, str]) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(id_to_name), f)

    def load_json(self, path: str, name_to_id: Dict[str, int]) -> None:
        """Resume history from a reference-format JSON (newest = list tail)."""
        with open(path) as f:
            data = json.load(f)
        for name, texts in data.items():
            if name not in name_to_id:
                continue
            sid = name_to_id[name]
            self.text_mirror[sid] = list(texts)
            recent = texts[-self.window:][::-1]
            for depth, text in enumerate(recent):
                enc, ln = self.charmap.encode([self.charmap.clean(text)])
                self.labels[sid, depth] = enc[0]
                self.lengths[sid, depth] = ln[0]
            self.counts[sid] = len(texts)
