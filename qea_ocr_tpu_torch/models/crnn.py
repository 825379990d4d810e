"""CRNN proxy (counterpart of `qea_ocr_tpu/models/crnn.py`): a 7-conv
ladder -> 2-layer BiLSTM -> linear -> log-softmax.

A (B, 1, 32, 128) strip becomes (B, 512, 1, 31) features, i.e. 31 CTC
timesteps; the output is time-major (T=31, B, V) float32 log-probs.
Parameter names follow the reference schema (`convo.conv1..7`,
`convo.batchnorm1..2`, `lstm.weight_ih_l{k}[_reverse]`, `linear`), so a
state_dict from `qea_ocr_tpu.tools.export_torch.state_dict_from_crnn` loads
with `strict=True`.

Dtype policy, as in JAX: float32 parameters; convs, LSTM matmuls and gate
nonlinearities and the output linear run in `compute_dtype` (bfloat16 by
default); the LSTM cell state, eval-mode batch norm and the log-softmax are
float32. The LSTM is written out step by step (both directions batched in
one `baddbmm` per step) rather than through cuDNN, whose fused RNN does not
expose this precision split (bf16 gates, f32 cell): it is the same recurrence
flax's `OptimizedLSTMCell` runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from qea_ocr_tpu_torch.models.unet import batch_norm, conv, reset_parameters


class ConvStack(nn.Module):
    """Seven convs with pools (2,2) (2,2) (2,1) (2,1) and a final valid 2x2
    conv; batch norm after conv5 and conv6."""

    def __init__(self, features=(64, 128, 256, 256, 512, 512, 512)):
        super().__init__()
        cin = 1
        for j, f in enumerate(features[:6], start=1):
            self.add_module(f"conv{j}", nn.Conv2d(cin, f, 3, padding=1))
            cin = f
        self.conv7 = nn.Conv2d(cin, features[6], 2)
        self.batchnorm1 = nn.BatchNorm2d(features[4], eps=1e-5, momentum=0.1)
        self.batchnorm2 = nn.BatchNorm2d(features[5], eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        x = F.max_pool2d(F.relu(conv(self.conv1, x, dt)), (2, 2))
        x = F.max_pool2d(F.relu(conv(self.conv2, x, dt)), (2, 2))
        x = F.relu(conv(self.conv3, x, dt))
        x = F.max_pool2d(F.relu(conv(self.conv4, x, dt)), (2, 1))
        x = F.relu(batch_norm(self.batchnorm1, conv(self.conv5, x, dt)))
        x = F.relu(batch_norm(self.batchnorm2, conv(self.conv6, x, dt)))
        x = F.max_pool2d(x, (2, 1))
        return conv(self.conv7, x, dt)


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM with `nn.LSTM`'s parameter names and gate
    order (i, f, g, o). Input and output are batch-major (B, T, C)."""

    def __init__(self, input_size: int, hidden: int, layers: int):
        super().__init__()
        self.hidden = hidden
        self.layers = layers
        for k in range(layers):
            cin = input_size if k == 0 else 2 * hidden
            for sfx in (f"l{k}", f"l{k}_reverse"):
                self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(
                    torch.empty(4 * hidden, cin)))
                self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(
                    torch.empty(4 * hidden, hidden)))
                self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(
                    torch.empty(4 * hidden)))
                self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(
                    torch.empty(4 * hidden)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def _layer(self, x: torch.Tensor, k: int, dt: torch.dtype) -> torch.Tensor:
        B, T, _ = x.shape
        H = self.hidden
        p = {n: torch.stack([getattr(self, f"{n}_l{k}"),
                             getattr(self, f"{n}_l{k}_reverse")])
             for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        # input projections for every step of both directions: (2, B, T, 4H)
        xw = torch.matmul(x.to(dt)[None],
                          p["weight_ih"].to(dt).transpose(1, 2)[:, None])
        w_hh = p["weight_hh"].to(dt).transpose(1, 2)              # (2, H, 4H)
        bias = (p["bias_ih"] + p["bias_hh"]).to(dt)[:, None, :]   # (2, 1, 4H)
        h = torch.zeros(2, B, H, device=x.device)
        c = torch.zeros(2, B, H, device=x.device)
        outs = []
        for t in range(T):
            xt = torch.stack([xw[0, :, t], xw[1, :, T - 1 - t]])  # (2, B, 4H)
            gates = torch.baddbmm(bias, h.to(dt), w_hh) + xt
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        fwd = torch.stack([hs[0] for hs in outs], dim=1)            # (B, T, H)
        bwd = torch.stack([hs[1] for hs in reversed(outs)], dim=1)
        return torch.cat([fwd, bwd], dim=-1)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        for k in range(self.layers):
            x = self._layer(x, k, dt)
        return x


class CRNN(nn.Module):
    """(B, 1, 32, 128) strips -> (31, B, vocab_size) float32 log-probs."""

    def __init__(self, vocab_size: int, lstm_hidden: int = 256,
                 lstm_layers: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.convo = ConvStack()
        self.lstm = BiLSTM(512, lstm_hidden, lstm_layers)
        self.linear = nn.Linear(2 * lstm_hidden, vocab_size)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        reset_parameters(self, g)
        self.lstm.reset_parameters(g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        feat = self.convo(x.to(dt), dt)                       # (B, C, 1, 31)
        B, C, Hf, Wf = feat.shape
        seq = feat.permute(0, 3, 2, 1).reshape(B, Wf, Hf * C)  # (B, T, C)
        seq = self.lstm(seq, dt)
        logits = F.linear(seq.to(dt), self.linear.weight.to(dt),
                          self.linear.bias.to(dt))             # (B, T, V)
        return torch.log_softmax(logits.transpose(0, 1).float(), dim=2)
