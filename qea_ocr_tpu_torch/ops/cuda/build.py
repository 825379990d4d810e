"""Build the port's CUDA kernels from `qea_ocr_tpu_torch/csrc/` at first use.

Each `csrc/<name>.cu` exports plain C launch functions and compiles on its
own with `nvcc` into `qea_ocr_tpu_torch/_build/lib<name>-<hash>.so`, which
the wrappers load with `ctypes`. No PyTorch headers are involved, so a
kernel builds in seconds. The hash covers the source and the flags, so an
edited source rebuilds; a file lock keeps concurrent processes from
building the same library twice. A missing or failing `nvcc` raises with
its output: there is no prebuilt fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("gather", "ctc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """`nvcc` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        f"nvcc not found on PATH or under {cuda_home}/bin: the CUDA kernels "
        "in qea_ocr_tpu_torch/csrc cannot be built")


def library_path(name: str) -> Path:
    """Where the library for `csrc/<name>.cu` lives once built."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library of the same hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():        # another process built it while we waited
            return out
        tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


def build_all() -> list[Path]:
    """Build every kernel of the port (what `chip_smoke.py` times)."""
    return [build(name) for name in KERNELS]
