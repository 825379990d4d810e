"""Launch wrapper of the channel-major 3x3 conv kernel (`csrc/conv_cmajor.cu`).

`conv_flat_cuda` takes CUDA tensors only and launches the kernel or raises;
the plain PyTorch version and the dispatch by device live in
`qea_ocr_tpu_torch/ops/conv_cmajor.py`. `pack_weights` is the layout the
kernel's weight copies read, a plain function.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0
MAX_GRID_YZ = 65535   # CUDA's limit on gridDim.y and gridDim.z
CK = 16               # input channels a chunk (the wgmma K)
WIDTH_MULTIPLE = 8    # TMA wants 16-byte row strides and base
# The kernel's tiles (`Tile` in the source): a block covers N output
# channels (Cout rounded up to the next of these; more than 256 go to
# further blocks) and 2 * rows_per_wg(N) image rows of 64 columns.
BLOCK_N = (16, 32, 64, 128, 256)


def tile(cout: int) -> tuple[int, int]:
    """(channels, rows) of one block for `cout` output channels."""
    n = next((n for n in BLOCK_N if cout <= n), BLOCK_N[-1])
    return n, 2 * (1 if n >= 256 else 2 if n >= 128 else 4)


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
    n, rows = tile(cout)
    return batch * -(-cout // n) <= MAX_GRID_YZ \
        and -(-height // rows) <= MAX_GRID_YZ


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> bfloat16 (9, ceil(Cin/16), ceil(Cout/8)*8,
    16), zero-padded: [tap = 3*dy + dx][input-channel chunk][co][ci in the
    chunk], so each (tap, chunk) is one K-major [co][16] tile."""
    cin, cout = w.shape[2], w.shape[3]
    nch, cout8 = -(-cin // CK), -(-cout // 8) * 8
    packed = torch.zeros((9, nch * CK, cout8), dtype=torch.bfloat16,
                         device=w.device)
    packed[:, :cin, :cout] = w.reshape(9, cin, cout)
    return packed.reshape(9, nch, CK, cout8).transpose(2, 3).contiguous()


def conv_flat_cuda(xf: torch.Tensor, w: torch.Tensor,
                   shift: torch.Tensor | None, height: int,
                   width: int) -> torch.Tensor:
    """Launch the kernel: xf (D, Cin, (H+2)*W) bfloat16 with W % 8 == 0, w
    (3, 3, Cin, Cout) HWIO bfloat16, shift (Cout,) float32 or None (None: no
    epilogue; else relu(y + shift)), on one CUDA device, xf and shift
    contiguous -> (D, Cout, (H+2)*W) bfloat16 with zero halo rows. No
    gradient: `ops/conv_cmajor.py` carries it."""
    global launches
    if xf.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (
            shift is not None and shift.dtype != torch.float32):
        raise TypeError(
            f"conv kernel takes bfloat16 activations and weights and a "
            f"float32 shift, got {xf.dtype}, {w.dtype}, "
            f"{None if shift is None else shift.dtype}")
    if xf.dim() != 3 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != xf.shape[1] or xf.shape[1] < 1 \
            or xf.shape[2] != (height + 2) * width \
            or (shift is not None and tuple(shift.shape) != (w.shape[3],)):
        raise ValueError(
            f"bad shapes: xf {tuple(xf.shape)} (want (D, Cin >= 1, "
            f"{(height + 2) * width})), w {tuple(w.shape)} (want (3, 3, "
            f"Cin, Cout)), shift "
            f"{None if shift is None else tuple(shift.shape)}")
    if width % WIDTH_MULTIPLE:
        raise ValueError(f"conv kernel takes widths that are a multiple of "
                         f"{WIDTH_MULTIPLE}, got {width}")
    others = [w] + ([] if shift is None else [shift])
    if xf.device.type != "cuda" or any(o.device != xf.device for o in others):
        raise ValueError("conv kernel takes CUDA tensors on one device, got "
                         + ", ".join(str(o.device) for o in [xf] + others))
    if not (xf.is_contiguous() and (shift is None or shift.is_contiguous())):
        raise ValueError("conv kernel takes contiguous activations and shift")
    D, cin, _ = xf.shape
    cout = w.shape[3]
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
    if xf.data_ptr() % 16:
        raise ValueError("conv kernel takes 16-byte aligned activations")
    packed = pack_weights(w)
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qea_conv_cmajor(
            xf.data_ptr(), packed.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(),
            D, cin, cout, height, width, stream)
    if rc != 0:
        raise RuntimeError("conv kernel launch failed: "
                           + lib.qea_conv_cmajor_error_string(rc).decode())
    launches += 1
    return out
