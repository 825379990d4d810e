"""Strip-gather forward: the CUDA kernel `csrc/gather.cu` and its plain
PyTorch version.

`text_stack(docs, bboxes)` crops every box `[x_min, y_min, x_max, y_max]`
out of its document and centres it in an `h_out x w_out` tile, white (1.0)
outside the crop; source coordinates clamp to the document's edge (the XLA
semantics of `qea_ocr_tpu/ops/text_stack.py:_extract_one`). A CPU tensor
takes `text_stack_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def text_stack_plain(docs: torch.Tensor, bboxes: torch.Tensor,
                     h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """docs (D, 1, H, W) float, bboxes (D, S, 4) int -> (D, S, h_out, w_out)."""
    D, _, H, W = docs.shape
    S = bboxes.shape[1]
    b = bboxes.long()
    x_min, y_min, x_max, y_max = b.unbind(-1)                     # (D, S)
    pad_top = torch.div(h_out - (y_max - y_min), 2, rounding_mode="floor")
    pad_left = torch.div(w_out - (x_max - x_min), 2, rounding_mode="floor")
    rows = (y_min - pad_top)[..., None] + torch.arange(h_out, device=docs.device)
    cols = (x_min - pad_left)[..., None] + torch.arange(w_out, device=docs.device)
    row_ok = (rows >= y_min[..., None]) & (rows < y_max[..., None])
    col_ok = (cols >= x_min[..., None]) & (cols < x_max[..., None])
    idx = (rows.clamp(0, H - 1)[..., :, None] * W
           + cols.clamp(0, W - 1)[..., None, :])                   # (D,S,h,w)
    patch = torch.gather(docs.reshape(D, H * W), 1,
                         idx.reshape(D, -1)).reshape(D, S, h_out, w_out)
    valid = row_ok[..., :, None] & col_ok[..., None, :]
    return torch.where(valid, patch, torch.ones((), dtype=docs.dtype,
                                                device=docs.device))


def _lib() -> ctypes.CDLL:
    lib = build.load("gather")
    fn = lib.qea_gather_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qea_gather_error_string.argtypes = [ctypes.c_int]
        lib.qea_gather_error_string.restype = ctypes.c_char_p
    return lib


def text_stack_cuda(docs: torch.Tensor, bboxes: torch.Tensor,
                    h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """Launch `csrc/gather.cu` on CUDA tensors: docs (D, 1, H, W) float32,
    bboxes (D, S, 4) int32, both contiguous on one device."""
    global launches
    if docs.requires_grad:
        raise NotImplementedError(
            "the strip-gather CUDA kernel has no backward yet; call it on "
            "tensors that do not require grad")
    if docs.dtype != torch.float32 or bboxes.dtype != torch.int32:
        raise TypeError(f"gather kernel takes float32 docs and int32 boxes, "
                        f"got {docs.dtype} and {bboxes.dtype}")
    if docs.dim() != 4 or docs.shape[1] != 1 or bboxes.dim() != 3 \
            or bboxes.shape[0] != docs.shape[0] or bboxes.shape[2] != 4:
        raise ValueError(f"bad shapes: docs {tuple(docs.shape)} (want "
                         f"(D,1,H,W)), bboxes {tuple(bboxes.shape)} "
                         "(want (D,S,4))")
    if docs.device.type != "cuda" or bboxes.device != docs.device:
        raise ValueError(f"gather kernel takes CUDA tensors on one device, "
                         f"got docs on {docs.device}, bboxes on "
                         f"{bboxes.device}")
    if not (docs.is_contiguous() and bboxes.is_contiguous()):
        raise ValueError("gather kernel takes contiguous tensors")
    D, _, H, W = docs.shape
    S = bboxes.shape[1]
    out = torch.empty((D, S, h_out, w_out), dtype=torch.float32,
                      device=docs.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(docs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_gather_fwd(docs.data_ptr(), bboxes.data_ptr(),
                                out.data_ptr(), D, S, H, W, h_out, w_out,
                                stream)
    if rc != 0:
        raise RuntimeError("gather kernel launch failed: "
                           + lib.qea_gather_error_string(rc).decode())
    launches += 1
    return out


def text_stack(docs: torch.Tensor, bboxes: torch.Tensor,
               h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """(D, 1, H, W) docs, (D, S, 4) boxes -> (D, S, h_out, w_out) strips."""
    if docs.device.type == "cpu":
        return text_stack_plain(docs, bboxes, h_out, w_out)
    if docs.device.type == "cuda":
        return text_stack_cuda(docs, bboxes, h_out, w_out)
    raise ValueError(f"no strip gather for device {docs.device}")
