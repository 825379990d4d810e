"""HistoryAttention: self-attention loss-weight generator over the label
history (counterpart of `qea_ocr_tpu/models/attention.py`, reference
`models/model_attention.py:7-38`).

A (vocab_size + 1, emb) character embedding table with a zeroed pad row
(frozen by default: a buffer), characters mean-pooled to word embeddings,
learned positional encodings over the history window, scores
softmax(Q Q^T / sqrt(Dq)), then a Linear(window -> 1) and a sigmoid, softmax
or relu-normalise to per-slot weights. It runs on all strips at once: input
(B, window, max_char_len) character indices, output (B, window) weights.

`state_dict` names: `embedding`, `positional_encodings`, `Wq.weight`,
`Wq.bias`, `loss_coef_layer.weight`, `loss_coef_layer.bias`;
`tools/convert.py:attention_state_dict` fills them from the flax variables.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class HistoryAttention(nn.Module):
    def __init__(self, char_vocab_size: int, emb_size: int = 256,
                 query_dim: int = 32, window_size: int = 1,
                 activation: str = "sigmoid", is_emb_train: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if activation not in ("sigmoid", "softmax", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.query_dim = query_dim
        self.activation = activation
        emb = torch.randn((char_vocab_size + 1, emb_size), generator=gen)
        emb[char_vocab_size] = 0.0            # the pad id's row
        if is_emb_train:
            self.embedding = nn.Parameter(emb)
        else:
            self.register_buffer("embedding", emb)
        self.positional_encodings = nn.Parameter(
            torch.zeros((window_size, emb_size)))
        self.Wq = nn.Linear(emb_size, query_dim)
        self.loss_coef_layer = nn.Linear(window_size, 1)
        with torch.no_grad():
            for layer in (self.Wq, self.loss_coef_layer):
                bound = 1.0 / math.sqrt(layer.in_features)
                layer.weight.uniform_(-bound, bound, generator=gen)
                layer.bias.zero_()

    def forward(self, char_indices: torch.Tensor) -> torch.Tensor:
        """char_indices: (..., window, max_char_len) int in [0, vocab_size];
        vocab_size is the pad id. Returns (..., window) float32 weights."""
        word_embs = self.embedding[char_indices.long()].mean(dim=-2)
        word_embs = word_embs + self.positional_encodings
        query = self.Wq(word_embs)                       # (..., window, Dq)
        scores = query @ query.transpose(-1, -2) / math.sqrt(self.query_dim)
        attn = torch.softmax(scores, dim=-1)         # (..., window, window)
        coef = self.loss_coef_layer(attn)[..., 0]        # (..., window)
        if self.activation == "sigmoid":
            return torch.sigmoid(coef)
        if self.activation == "softmax":
            return torch.softmax(coef, dim=-1)
        w = torch.relu(coef)
        return w / (w.sum(dim=-1, keepdim=True) + 1e-6)
