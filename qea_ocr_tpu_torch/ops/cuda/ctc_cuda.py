"""CTC forward (alpha recursion): the CUDA kernel `csrc/ctc.cu` and its
plain PyTorch version.

`ctc_nll(log_probs, labels, lengths, pad_id, blank_id)` returns each row's
CTC negative log-likelihood with the semantics of the TPU kernel
(`qea_ocr_tpu/ops/pallas/ctc_pallas.py`): pad labels count as blank, a
zero-length label scores -sum_t log p(blank), and a row no alignment fits
scores exactly 1e5. A CPU tensor takes `ctc_nll_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

NEG = -1e30          # the kernels' -inf surrogate
INFEASIBLE_NLL = 1e5  # clamp for rows no alignment fits
MAX_EXTENDED = 1024  # one thread per extended label: S = 2L+1 <= 1024

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, torch.maximum(b, c))
    ok = m > NEG / 2
    safe = torch.where(ok, m, torch.zeros_like(m))
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe)
                           + torch.exp(c - safe))
    return torch.where(ok, out, torch.full_like(m, NEG))


def ctc_nll_plain(log_probs: torch.Tensor, labels: torch.Tensor,
                  lengths: torch.Tensor, pad_id: int,
                  blank_id: int = 0) -> torch.Tensor:
    """log_probs (T, B, V) float32, labels (B, L) int, lengths (B,) int
    -> (B,) float32 NLL."""
    T, B, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    lab = torch.where(labels == pad_id, blank_id, labels).long()
    z = torch.full((B, S), blank_id, dtype=torch.long, device=dev)
    z[:, 1::2] = lab
    z_m2 = torch.cat([torch.full((B, 2), blank_id, dtype=torch.long,
                                 device=dev), z[:, :-2]], dim=1)
    col = torch.arange(S, device=dev)
    skip = (z != blank_id) & (z != z_m2) & (col >= 2)
    z_ok = (z >= 0) & (z < V)
    emit = torch.gather(log_probs.float(), 2,
                        z.clamp(0, V - 1)[None].expand(T, B, S))
    emit = torch.where(z_ok, emit, torch.full_like(emit, NEG))   # (T, B, S)

    neg2 = torch.full((B, 2), NEG, device=dev)
    a = torch.where(col < 2, emit[0], torch.full_like(emit[0], NEG))
    for t in range(1, T):
        a1 = torch.cat([neg2[:, :1], a[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg2, a[:, :-2]], dim=1),
                         torch.full_like(a, NEG))
        a = _lse3(a, a1, a2) + emit[t]

    ln = lengths.long()
    in_range = (ln >= 0) & (ln <= L)
    elen = 2 * ln.clamp(0, L) + 1
    last1 = a.gather(1, (elen - 1)[:, None])[:, 0]
    last2 = torch.where(elen >= 2,
                        a.gather(1, (elen - 2).clamp(min=0)[:, None])[:, 0],
                        torch.full_like(last1, NEG))
    m = torch.maximum(last1, last2)
    ok = m > NEG / 2
    safe = torch.where(ok, m, torch.zeros_like(m))
    logz = safe + torch.log(torch.exp(last1 - safe) + torch.exp(last2 - safe))
    nll = torch.where(ok & in_range, -logz,
                      torch.full_like(logz, INFEASIBLE_NLL))
    return torch.clamp(nll, max=INFEASIBLE_NLL)


def _lib() -> ctypes.CDLL:
    lib = build.load("ctc")
    fn = lib.qea_ctc_alpha_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qea_ctc_error_string.argtypes = [ctypes.c_int]
        lib.qea_ctc_error_string.restype = ctypes.c_char_p
    return lib


def ctc_nll_cuda(log_probs: torch.Tensor, labels: torch.Tensor,
                 lengths: torch.Tensor, pad_id: int,
                 blank_id: int = 0) -> torch.Tensor:
    """Launch `csrc/ctc.cu`: log_probs (T, B, V) float32, labels (B, L)
    int32, lengths (B,) int32, all contiguous on one CUDA device."""
    global launches
    if log_probs.requires_grad:
        raise NotImplementedError(
            "the CTC CUDA kernel has no backward yet; call it on tensors "
            "that do not require grad")
    if log_probs.dtype != torch.float32 or labels.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("CTC kernel takes float32 log-probs and int32 labels "
                        f"and lengths, got {log_probs.dtype}, {labels.dtype}, "
                        f"{lengths.dtype}")
    if log_probs.dim() != 3 or labels.dim() != 2 or lengths.dim() != 1:
        raise ValueError("want log_probs (T, B, V), labels (B, L), lengths "
                         f"(B,); got {tuple(log_probs.shape)}, "
                         f"{tuple(labels.shape)}, {tuple(lengths.shape)}")
    T, B, V = log_probs.shape
    L = labels.shape[1]
    if labels.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(f"batch mismatch: log_probs B={B}, labels "
                         f"{labels.shape[0]}, lengths {lengths.shape[0]}")
    if T < 1 or 2 * L + 1 > MAX_EXTENDED:
        raise ValueError(f"CTC kernel takes T >= 1 and 2L+1 <= "
                         f"{MAX_EXTENDED}; got T={T}, L={L}")
    if log_probs.device.type != "cuda" or not (
            log_probs.device == labels.device == lengths.device):
        raise ValueError("CTC kernel takes CUDA tensors on one device, got "
                         f"{log_probs.device}, {labels.device}, "
                         f"{lengths.device}")
    if not (log_probs.is_contiguous() and labels.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("CTC kernel takes contiguous tensors")
    nll = torch.empty((B,), dtype=torch.float32, device=log_probs.device)
    if B == 0:
        return nll
    lib = _lib()
    with torch.cuda.device(log_probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_ctc_alpha_fwd(log_probs.data_ptr(), labels.data_ptr(),
                                   lengths.data_ptr(), nll.data_ptr(),
                                   T, B, V, L, pad_id, blank_id, stream)
    if rc != 0:
        raise RuntimeError("CTC kernel launch failed: "
                           + lib.qea_ctc_error_string(rc).decode())
    launches += 1
    return nll


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor,
            lengths: torch.Tensor, pad_id: int,
            blank_id: int = 0) -> torch.Tensor:
    """(T, B, V) log-probs, (B, L) labels, (B,) lengths -> (B,) NLL."""
    if log_probs.device.type == "cpu":
        return ctc_nll_plain(log_probs, labels, lengths, pad_id, blank_id)
    if log_probs.device.type == "cuda":
        return ctc_nll_cuda(log_probs, labels, lengths, pad_id, blank_id)
    raise ValueError(f"no CTC loss for device {log_probs.device}")
