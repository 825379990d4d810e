"""ctypes bindings for the native host-ops library (native/qea_native.cpp):
the port's own copy of `qea_ocr_tpu/utils/native.py` (numpy and ctypes
only), loading the same library from the repository's `native/` directory.

Provides OpenMP-parallel batch Levenshtein / CTC collapse / label comparison
for host-side paths (OCR post-processing, CER seeding, weight generation on
host). Device-side equivalents live in `qea_ocr_tpu_torch.ops`.

The library builds on first use (`make` with the machine's C++ compiler)
and every entry point has a pure-numpy fallback, so the port works without
a toolchain; `have_native()` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libqea_native.so")

_ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        # Rebuild BEFORE the first dlopen: glibc caches handles by path, so
        # probing a stale .so and then re-loading after `make` would hand
        # back the old image for the rest of the process. `make` is a no-op
        # when the .so is newer than the source, and a failed make (no
        # toolchain) still falls through to loading an existing build.
        # Inter-process build lock: concurrent first-users (parallel
        # pytest, a quality run next to bench) must not race `make`'s
        # write of the .so — a torn write fails the dlopen/version check
        # and silently drops every process to the slow Python paths.
        try:
            import fcntl
            lock_path = os.path.join(_NATIVE_DIR, ".build.lock")
            with open(lock_path, "w") as lock_f:
                fcntl.flock(lock_f, fcntl.LOCK_EX)
                try:
                    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                                   capture_output=True, timeout=120)
                finally:
                    fcntl.flock(lock_f, fcntl.LOCK_UN)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                raise
        lib = ctypes.CDLL(_LIB_PATH)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.qea_batch_levenshtein.argtypes = [i32p, i32p, i32p, i32p,
                                              ctypes.c_int32, ctypes.c_int32,
                                              ctypes.c_int32, i32p]
        lib.qea_pairwise_levenshtein.argtypes = [i32p, i32p, ctypes.c_int32,
                                                 ctypes.c_int32,
                                                 ctypes.c_int32, i32p]
        lib.qea_ctc_collapse.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32,
                                         i32p, i32p]
        lib.qea_compare_labels.argtypes = [i32p, i32p, i32p, i32p,
                                           ctypes.c_int32, ctypes.c_int32,
                                           ctypes.c_int32,
                                           ctypes.POINTER(ctypes.c_int32),
                                           ctypes.POINTER(ctypes.c_double)]
        lib.qea_facility_location.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            i32p]
        lib.qea_version.restype = ctypes.c_int32
        assert lib.qea_version() == _ABI_VERSION
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def have_native() -> bool:
    return _load() is not None


def _as_i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---------------------------------------------------------------------------
def batch_levenshtein(a, a_len, b, b_len) -> np.ndarray:
    """(B, L1), (B,), (B, L2), (B,) int -> (B,) int32 distances."""
    a, b = _as_i32(a), _as_i32(b)
    a_len, b_len = _as_i32(a_len), _as_i32(b_len)
    B, L1 = a.shape
    L2 = b.shape[1]
    lib = _load()
    if lib is not None:
        out = np.empty(B, np.int32)
        lib.qea_batch_levenshtein(_ptr(a), _ptr(a_len), _ptr(b), _ptr(b_len),
                                  B, L1, L2, _ptr(out))
        return out
    return np.asarray([_py_lev(a[i, :a_len[i]], b[i, :b_len[i]])
                       for i in range(B)], np.int32)


def pairwise_levenshtein(labels, lengths) -> np.ndarray:
    """(B, W, L), (B, W) -> (B, W, W) int32 pairwise distances."""
    labels = _as_i32(labels)
    lengths = _as_i32(lengths)
    B, W, L = labels.shape
    lib = _load()
    if lib is not None:
        out = np.empty((B, W, W), np.int32)
        lib.qea_pairwise_levenshtein(_ptr(labels), _ptr(lengths), B, W, L,
                                     _ptr(out))
        return out
    out = np.zeros((B, W, W), np.int32)
    for b in range(B):
        for i in range(W):
            for j in range(i + 1, W):
                d = _py_lev(labels[b, i, :lengths[b, i]],
                            labels[b, j, :lengths[b, j]])
                out[b, i, j] = out[b, j, i] = d
    return out


def ctc_collapse(ids, blank: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, T) argmax ids -> (collapsed (B, T) pad-filled, lengths (B,))."""
    ids = _as_i32(ids)
    B, T = ids.shape
    lib = _load()
    if lib is not None:
        out = np.empty((B, T), np.int32)
        out_len = np.empty(B, np.int32)
        lib.qea_ctc_collapse(_ptr(ids), B, T, blank, pad, _ptr(out),
                             _ptr(out_len))
        return out, out_len
    out = np.full((B, T), pad, np.int32)
    out_len = np.zeros(B, np.int32)
    for b in range(B):
        prev, n = blank, 0
        for v in ids[b]:
            if v != blank and v != prev:
                out[b, n] = v
                n += 1
            prev = v
        out_len[b] = n
    return out, out_len


def compare_labels(pred, pred_len, gt, gt_len) -> Tuple[int, float]:
    """-> (exact_match_count, total CER) — host-side reference
    `compare_labels` semantics over int-encoded labels."""
    pred, gt = _as_i32(pred), _as_i32(gt)
    pred_len, gt_len = _as_i32(pred_len), _as_i32(gt_len)
    B, Lp = pred.shape
    Lg = gt.shape[1]
    lib = _load()
    if lib is not None:
        crt = ctypes.c_int32()
        cer = ctypes.c_double()
        lib.qea_compare_labels(_ptr(pred), _ptr(pred_len), _ptr(gt),
                               _ptr(gt_len), B, Lp, Lg,
                               ctypes.byref(crt), ctypes.byref(cer))
        return int(crt.value), float(cer.value)
    crt, cer = 0, 0.0
    for i in range(B):
        p = pred[i, :pred_len[i]].tolist()
        g = gt[i, :gt_len[i]].tolist()
        crt += int(p == g)
        cer += _py_lev(p, g) / max(1, len(g))
    return crt, cer


def string_cer(preds: Sequence[str], gts: Sequence[str]) -> Tuple[int, float]:
    """String convenience wrapper (encodes via ord codepoints)."""
    B = len(preds)
    Lp = max(1, max((len(s) for s in preds), default=1))
    Lg = max(1, max((len(s) for s in gts), default=1))
    p = np.zeros((B, Lp), np.int32)
    g = np.zeros((B, Lg), np.int32)
    pl = np.zeros(B, np.int32)
    gl = np.zeros(B, np.int32)
    for i, (a, b) in enumerate(zip(preds, gts)):
        p[i, :len(a)] = [ord(c) for c in a]
        g[i, :len(b)] = [ord(c) for c in b]
        pl[i], gl[i] = len(a), len(b)
    return compare_labels(p, pl, g, gl)


def facility_location_indices(x, k: int) -> np.ndarray:
    """Greedy facility-location over 1-D features x (n,) -> (min(k, n),)
    selected indices in pick order. sim = dmax - |x_i - x_j|; ties go to the
    lowest index (numpy-argmax semantics in both implementations)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    n = x.shape[0]
    k = int(min(k, n))
    if k <= 0:
        return np.empty(0, np.int32)
    lib = _load()
    if lib is not None:
        out = np.empty(k, np.int32)
        lib.qea_facility_location(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k,
            _ptr(out))
        return out
    dmax = float(x.max() - x.min()) if n else 0.0
    sim = dmax - np.abs(x[:, None] - x[None, :])
    best = np.zeros(n)
    taken = np.zeros(n, bool)
    out = np.empty(k, np.int32)
    for r in range(k):
        gains = np.maximum(sim - best[None, :], 0.0).sum(axis=1)
        gains[taken] = -1.0
        i = int(np.argmax(gains))
        taken[i] = True
        out[r] = i
        best = np.maximum(best, sim[i])
    return out


def _py_lev(a, b) -> int:
    a, b = list(a), list(b)
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[n]
