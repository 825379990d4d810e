"""Strip gather, forward and backward: the CUDA kernels of
`csrc/gather.cu` and their plain PyTorch version.

`text_stack(docs, bboxes)` crops every box `[x_min, y_min, x_max, y_max]`
out of its document and centres it in an `h_out x w_out` tile, white (1.0)
outside the crop; source coordinates clamp to the document's edge (the XLA
semantics of `qea_ocr_tpu/ops/text_stack.py:_extract_one`). It is
differentiable in `docs`: every tile cell's gradient is added to the
document pixel it was read from, overlapping boxes and clamped edge cells
included. A CPU tensor takes `text_stack_plain` (and autograd through it,
whose `torch.gather` backward is that sum); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

# Kernel launches since the last reset (read and reset by chip_smoke.py):
# the forward kernel and the backward kernel.
launches = 0
bwd_launches = 0
MAX_DOCS = 65535    # the backward's grid puts documents on blockIdx.z


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
        lib.qea_gather_bwd.argtypes = fn.argtypes
        lib.qea_gather_bwd.restype = ctypes.c_int
        lib.qea_gather_error_string.argtypes = [ctypes.c_int]
        lib.qea_gather_error_string.restype = ctypes.c_char_p
    return lib


def _check(docs_shape, docs: torch.Tensor, bboxes: torch.Tensor,
           what: str) -> None:
    """`docs` is the float32 tensor handed to the kernel (the documents, or
    the tiles' gradient), `docs_shape` the documents' shape."""
    if docs.dtype != torch.float32 or bboxes.dtype != torch.int32:
        raise TypeError(f"gather kernel takes float32 {what} and int32 "
                        f"boxes, got {docs.dtype} and {bboxes.dtype}")
    if len(docs_shape) != 4 or docs_shape[1] != 1 or bboxes.dim() != 3 \
            or bboxes.shape[0] != docs_shape[0] or bboxes.shape[2] != 4:
        raise ValueError(f"bad shapes: docs {tuple(docs_shape)} (want "
                         f"(D,1,H,W)), bboxes {tuple(bboxes.shape)} "
                         "(want (D,S,4))")
    if docs.device.type != "cuda" or bboxes.device != docs.device:
        raise ValueError(f"gather kernel takes CUDA tensors on one device, "
                         f"got {what} on {docs.device}, bboxes on "
                         f"{bboxes.device}")
    if not (docs.is_contiguous() and bboxes.is_contiguous()):
        raise ValueError("gather kernel takes contiguous tensors")


def text_stack_cuda(docs: torch.Tensor, bboxes: torch.Tensor,
                    h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: docs (D, 1, H, W) float32,
    bboxes (D, S, 4) int32, both contiguous on one device. No gradient:
    `text_stack` carries it."""
    global launches
    _check(docs.shape, docs, bboxes, "docs")
    D, _, H, W = docs.shape
    S = bboxes.shape[1]
    lib = _lib()
    out = torch.empty((D, S, h_out, w_out), dtype=torch.float32,
                      device=docs.device)
    if out.numel() == 0:
        return out
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


def text_stack_bwd_cuda(grads: torch.Tensor, bboxes: torch.Tensor,
                        docs_shape) -> torch.Tensor:
    """Launch the backward kernel: grads (D, S, h_out, w_out) float32, the
    gradient of `text_stack_cuda`'s output, and the boxes it was called
    with -> the gradient of its (D, 1, H, W) documents."""
    global bwd_launches
    _check(docs_shape, grads, bboxes, "gradients")
    D, _, H, W = docs_shape
    S = bboxes.shape[1]
    if grads.dim() != 4 or grads.shape[:2] != (D, S):
        raise ValueError(f"gradients {tuple(grads.shape)} do not match "
                         f"{D} documents x {S} strips")
    if D > MAX_DOCS:
        raise ValueError(f"gather backward takes D <= {MAX_DOCS}; got D={D}")
    h_out, w_out = grads.shape[2:]
    lib = _lib()
    out = torch.empty(tuple(docs_shape), dtype=torch.float32,
                      device=grads.device)
    if out.numel() == 0:
        return out
    if grads.numel() == 0:
        return out.zero_()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_gather_bwd(grads.data_ptr(), bboxes.data_ptr(),
                                out.data_ptr(), D, S, H, W, h_out, w_out,
                                stream)
    if rc != 0:
        raise RuntimeError("gather backward kernel launch failed: "
                           + lib.qea_gather_error_string(rc).decode())
    bwd_launches += 1
    return out


class _TextStackCuda(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, docs, bboxes, h_out, w_out):
        ctx.save_for_backward(bboxes)
        ctx.docs_shape = tuple(docs.shape)
        return text_stack_cuda(docs, bboxes, h_out, w_out)

    @staticmethod
    def backward(ctx, grads):
        (bboxes,) = ctx.saved_tensors
        return text_stack_bwd_cuda(grads.float().contiguous(), bboxes,
                                   ctx.docs_shape), None, None, None


def text_stack(docs: torch.Tensor, bboxes: torch.Tensor,
               h_out: int = 32, w_out: int = 128) -> torch.Tensor:
    """(D, 1, H, W) docs, (D, S, 4) boxes -> (D, S, h_out, w_out) strips."""
    if docs.device.type == "cpu":
        return text_stack_plain(docs, bboxes, h_out, w_out)
    if docs.device.type == "cuda":
        if docs.requires_grad and torch.is_grad_enabled():
            return _TextStackCuda.apply(docs, bboxes, h_out, w_out)
        return text_stack_cuda(docs, bboxes, h_out, w_out)
    raise ValueError(f"no strip gather for device {docs.device}")
