"""Batch norm + ReLU on channels-last activations: the CUDA kernels of
`csrc/bn_relu.cu`, one function a step of `ops/bn_relu.py`.

Each function takes CUDA tensors laid out as (rows, C) with the channels
contiguous: a 4-D (N, C, H, W) tensor in `torch.channels_last` (the
wrapper makes it so where it is not), in bfloat16 or float32. Per-channel
values are float32 (`stat`: the rows mean, invstd, scale, shift; `sums`:
the rows sum g, sum g * xhat). Every launch goes on the current stream and
raises where the kernel refused it.
"""

from __future__ import annotations

import ctypes

import torch

from qea_ocr_tpu_torch.ops.cuda import build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches since the last reset (read and reset by chip_smoke.py and
# the tests): those of the forward (statistics, finalise, apply) and those
# of the backward (sums, their merge, dx).
launches = 0
bwd_launches = 0

_max_parts: dict = {}   # device index -> the most partials a launch writes

_P, _I64, _INT, _F32, _F64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_float, ctypes.c_double)


def _lib() -> ctypes.CDLL:
    lib = build.load("bn_relu")
    if lib.qea_bn_stats.argtypes is None:
        sig = {
            "qea_bn_max_parts": [],
            "qea_bn_stats": [_P, _I64, _INT, _INT, _P, _P, _P, _P],
            "qea_bn_finalise": [_P, _P, _INT, _INT, _P, _P, _F32, _F32, _P,
                                _P, _P, _P, _P, _P],
            "qea_bn_apply": [_P, _I64, _INT, _INT, _P, _P, _P],
            "qea_bn_bwd_reduce": [_P, _P, _I64, _INT, _INT, _P, _P, _P, _P],
            "qea_bn_sum": [_P, _INT, _INT, _P, _P],
            "qea_bn_dx": [_P, _P, _I64, _INT, _INT, _P, _P, _F64, _P, _P],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.qea_bn_error_string.argtypes = [ctypes.c_int]
        lib.qea_bn_error_string.restype = ctypes.c_char_p
    return lib


def _run(what: str, fn, *args) -> None:
    """Call a launcher with the current stream as its last argument."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"batch-norm {what} kernel launch failed: "
                           + _lib().qea_bn_error_string(rc).decode())


def rows_view(t: torch.Tensor) -> torch.Tensor:
    """`t` (N, C, H, W) on CUDA as the kernels read it: channels-last and
    dense, so that its memory is (N*H*W, C). Raises for what they do not
    take (dtype, then shape, then device), before any launch."""
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"batch-norm kernels take bfloat16 or float32, got "
                        f"{t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"batch-norm kernels take (N, C, H, W), got "
                         f"{tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"batch norm over no rows: {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"batch-norm kernels take CUDA tensors, got "
                         f"{t.device}")
    return t.contiguous(memory_format=torch.channels_last)


def _parts_buffer(y: torch.Tensor) -> torch.Tensor:
    """Room for the partials a row kernel writes on y's device: (P, 2, C)."""
    index = y.device.index
    if index not in _max_parts:
        _max_parts[index] = _lib().qea_bn_max_parts()
    return torch.empty((_max_parts[index], 2, y.shape[1]),
                       dtype=torch.float32, device=y.device)


def _rows(t: torch.Tensor) -> int:
    return t.numel() // t.shape[1]


def _on(t: torch.Tensor):
    return torch.cuda.device(t.device)


def moments(y: torch.Tensor):
    """y's per-block Welford partials: (part (P, 2, C) of mean and M2,
    counts (P,) float64)."""
    global launches
    lib = _lib()
    C = y.shape[1]
    with _on(y):
        part = _parts_buffer(y)
        counts = torch.empty((part.shape[0],), dtype=torch.float64,
                             device=y.device)
        parts = ctypes.c_int(0)
        _run("statistics", lib.qea_bn_stats, y.data_ptr(), _rows(y), C,
             _DTYPE_CODE[y.dtype], part.data_ptr(), counts.data_ptr(),
             ctypes.byref(parts))
    launches += 1
    return part[:parts.value], counts[:parts.value]


def finalise(part, counts, bn, weight, bias, move: bool):
    """The partials merged -> stat (4, C) (`part` None: from the running
    statistics); with `move`, the running statistics moved in place and
    `num_batches_tracked` counted."""
    global launches
    lib = _lib()
    C = bn.running_mean.shape[0]
    dev = bn.running_mean.device
    for t in (weight, bias, bn.running_mean, bn.running_var):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError("batch-norm kernels take contiguous float32 "
                             "parameters and statistics on the activations' "
                             "device")
    stat = torch.empty((4, C), dtype=torch.float32, device=dev)
    P = 0 if part is None else part.shape[0]
    with _on(stat):
        _run("finalise", lib.qea_bn_finalise,
             None if part is None else part.data_ptr(),
             None if part is None else counts.data_ptr(), P, C,
             weight.data_ptr(), bias.data_ptr(), bn.eps, bn.momentum,
             bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
             bn.num_batches_tracked.data_ptr() if move else None, None,
             stat.data_ptr())
    launches += 1
    return stat


def merged(part, counts) -> torch.Tensor:
    """The partials merged into one (2, C) of (mean, M2)."""
    global launches
    lib = _lib()
    C = part.shape[2]
    out = torch.empty((2, C), dtype=torch.float32, device=part.device)
    with _on(out):
        _run("finalise", lib.qea_bn_finalise, part.data_ptr(),
             counts.data_ptr(), part.shape[0], C, None, None, 0.0, 0.0,
             None, None, None, out.data_ptr(), None)
    launches += 1
    return out


def apply(y: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """z = relu(y * scale + shift) in y's dtype, channels-last."""
    global launches
    z = torch.empty_like(y, memory_format=torch.channels_last)
    with _on(y):
        _run("apply", _lib().qea_bn_apply, y.data_ptr(), _rows(y),
             y.shape[1], _DTYPE_CODE[y.dtype], stat.data_ptr(), z.data_ptr())
    launches += 1
    return z


def grad_sums(dz: torch.Tensor, y: torch.Tensor,
              stat: torch.Tensor) -> torch.Tensor:
    """(2, C): sum g and sum g * xhat over y's rows."""
    global bwd_launches
    lib = _lib()
    C = y.shape[1]
    with _on(y):
        part = _parts_buffer(y)
        parts = ctypes.c_int(0)
        _run("sums", lib.qea_bn_bwd_reduce, dz.data_ptr(), y.data_ptr(),
             _rows(y), C, _DTYPE_CODE[y.dtype], stat.data_ptr(),
             part.data_ptr(), ctypes.byref(parts))
        sums = torch.empty((2, C), dtype=torch.float32, device=y.device)
        _run("sum", lib.qea_bn_sum, part.data_ptr(), parts.value, C,
             sums.data_ptr())
    bwd_launches += 2
    return sums


def grad_input(dz: torch.Tensor, y: torch.Tensor, stat: torch.Tensor,
               sums: torch.Tensor, n: int) -> torch.Tensor:
    """dx in y's dtype, channels-last, from the sums over n rows."""
    global bwd_launches
    dx = torch.empty_like(y, memory_format=torch.channels_last)
    with _on(y):
        _run("dx", _lib().qea_bn_dx, dz.data_ptr(), y.data_ptr(), _rows(y),
             y.shape[1], _DTYPE_CODE[y.dtype], stat.data_ptr(),
             sums.data_ptr(), float(n), dx.data_ptr())
    bwd_launches += 1
    return dx
