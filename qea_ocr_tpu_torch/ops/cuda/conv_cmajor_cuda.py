"""Launch wrapper of the channel-major 3x3 conv kernel (`csrc/conv_cmajor.cu`).

`conv_flat_cuda` takes CUDA tensors only and launches the kernel or raises;
the plain PyTorch version and the dispatch by device live in
`qea_ocr_tpu_torch/ops/conv_cmajor.py`.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0
MAX_GRID_YZ = 65535   # CUDA's limit on gridDim.y and gridDim.z
CO_PER_BLOCK = 64     # output channels one block covers at most
TILE_H = 8            # image rows one block covers


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_cmajor")
    fn = lib.qea_conv_cmajor
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.qea_conv_cmajor_error_string.argtypes = [ctypes.c_int]
        lib.qea_conv_cmajor_error_string.restype = ctypes.c_char_p
    return lib


def grid_fits(batch: int, cout: int, height: int) -> bool:
    """Whether the kernel's launch grid can cover this conv."""
    chunks = -(-cout // CO_PER_BLOCK)
    return batch * chunks <= MAX_GRID_YZ and -(-height // TILE_H) <= MAX_GRID_YZ


def conv_flat_cuda(xf: torch.Tensor, w9: torch.Tensor,
                   shift: torch.Tensor | None, height: int,
                   width: int) -> torch.Tensor:
    """Launch the kernel: xf (D, Cin, (H+2)*W) bfloat16, w9 (9, Cout, Cin)
    bfloat16 with tap = 3*dy + dx, shift (Cout,) float32 or None (None: no
    epilogue; else relu(y + shift)), all contiguous on one CUDA device
    -> (D, Cout, (H+2)*W) bfloat16 with zero halo rows. No gradient: `ops/conv_cmajor.py` carries it."""
    global launches
    if xf.dtype != torch.bfloat16 or w9.dtype != torch.bfloat16 or (
            shift is not None and shift.dtype != torch.float32):
        raise TypeError(
            f"conv kernel takes bfloat16 activations and weights and a "
            f"float32 shift, got {xf.dtype}, {w9.dtype}, "
            f"{None if shift is None else shift.dtype}")
    if xf.dim() != 3 or w9.dim() != 3 or w9.shape[0] != 9 \
            or w9.shape[2] != xf.shape[1] \
            or xf.shape[2] != (height + 2) * width \
            or (shift is not None and tuple(shift.shape) != (w9.shape[1],)):
        raise ValueError(
            f"bad shapes: xf {tuple(xf.shape)} (want (D, Cin, "
            f"{(height + 2) * width})), w9 {tuple(w9.shape)} (want (9, Cout, "
            f"Cin)), shift {None if shift is None else tuple(shift.shape)}")
    others = [w9] + ([] if shift is None else [shift])
    if xf.device.type != "cuda" or any(o.device != xf.device for o in others):
        raise ValueError("conv kernel takes CUDA tensors on one device, got "
                         + ", ".join(str(o.device) for o in [xf] + others))
    if not all(o.is_contiguous() for o in [xf] + others):
        raise ValueError("conv kernel takes contiguous tensors")
    D, cin, _ = xf.shape
    cout = w9.shape[1]
    if not grid_fits(D, cout, height):
        raise ValueError(f"conv kernel grid overflow: D={D}, Cout={cout}, "
                         f"H={height}")
    lib = _lib()
    out = torch.empty((D, cout, (height + 2) * width), dtype=torch.bfloat16,
                      device=xf.device)
    if out.numel() == 0:
        return out
    if height == 0:
        return out.zero_()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_conv_cmajor(
            xf.data_ptr(), w9.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(),
            D, cin, cout, height, width, stream)
    if rc != 0:
        raise RuntimeError("conv kernel launch failed: "
                           + lib.qea_conv_cmajor_error_string(rc).decode())
    launches += 1
    return out
