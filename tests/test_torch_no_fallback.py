"""The port imports neither JAX nor the JAX package, and never falls back to
the CPU or to a plain version when a GPU was asked for."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "qea_ocr_tpu_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_modules_never_import_jax():
    """After importing every module of the port and `chip_smoke.py` in a
    fresh interpreter, `sys.modules` holds neither JAX (or flax, optax) nor
    any module of the JAX package `qea_ocr_tpu`."""
    mods = _port_modules() + ["chip_smoke"]
    assert "qea_ocr_tpu_torch.ops.cuda.gather_cuda" in mods
    assert "qea_ocr_tpu_torch.train.patch_steps" in mods
    for new in ("ops.conv_cmajor", "ops.cuda.conv_cmajor_cuda",
                "selection.samplers", "selection.api", "tracking.history",
                "tracking.weights", "models.attention", "ocr.engine",
                "utils.io", "utils.metrics", "train.patch_trainer",
                "cli.patch_cli", "train.crnn_trainer", "cli.train_crnn",
                "eval.eval_utils", "eval.eval_crnn", "eval.eval_prep",
                "cli.eval_crnn", "cli.eval_prep", "utils.native",
                "tools.cer_seed", "tools.quality_run", "train.area_trainer",
                "cli.area_cli", "tools.import_torch", "tools.export_model",
                "parallel.mesh", "parallel.multihost", "parallel.tp",
                "pruning.prune", "tools.prune_cli", "tools.cer_analysis",
                "sweeps.sweep", "ocr.tesseract", "ocr.easyocr_backend",
                "ocr.gvision", "ocr.stub_engines",
                "tools.build_patch_dataset"):
        assert "qea_ocr_tpu_torch." + new in mods, new
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'qea_ocr_tpu') or m.startswith(('jax.', 'jaxlib', 'flax', "
            "'optax', 'qea_ocr_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_a_gpu():
    """With no CUDA device the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the script would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr


def test_cuda_device_without_gpu_raises(monkeypatch):
    from qea_ocr_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cuda_process_group_never_takes_gloo(monkeypatch):
    """A process group for a CUDA device is NCCL or nothing: without CUDA,
    or without NCCL, `maybe_init_distributed` raises before it makes a
    group, and a Gloo group that exists is refused to a CUDA run."""
    import torch.distributed as dist

    from qea_ocr_tpu_torch.parallel import multihost

    monkeypatch.setenv("QEA_DISTRIBUTED", "1")
    monkeypatch.setenv("QEA_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("QEA_NUM_PROCESSES", "1")
    monkeypatch.setenv("QEA_PROCESS_ID", "0")
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k:
                        pytest.fail("a group was made"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.maybe_init_distributed("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.maybe_init_distributed("cuda")
    assert multihost.backend_for("cpu") == "gloo"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(RuntimeError, match="needs nccl"):
        multihost.maybe_init_distributed("cuda")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from qea_ocr_tpu_torch.ops.cuda import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


class _CudaTyped:
    """Stands in for a contiguous tensor on a CUDA device, which this
    machine cannot make: enough of the interface for a kernel wrapper's
    checks, and nothing that could run on the CPU."""

    device = torch.device("cuda", 0)
    requires_grad = True

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def test_training_path_on_a_cuda_tensor_reaches_the_build(monkeypatch,
                                                          tmp_path):
    """A call that wants a gradient on CUDA-typed tensors does not raise
    NotImplementedError any more, and takes no quiet detour over the plain
    version either: it goes to build the kernels, and fails there for want
    of nvcc."""
    from qea_ocr_tpu_torch.ops.cuda import (
        build, conv_cmajor_cuda, ctc_cuda, gather_cuda)

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    lp = _CudaTyped((31, 4, 95), torch.float32)
    labels = _CudaTyped((4, 100), torch.int32)
    lengths = _CudaTyped((4,), torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ctc_cuda.ctc_nll(lp, labels, lengths, 95)
    docs = _CudaTyped((2, 1, 64, 64), torch.float32)
    boxes = _CudaTyped((2, 3, 4), torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather_cuda.text_stack(docs, boxes)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather_cuda.text_stack_bwd_cuda(
            _CudaTyped((2, 3, 32, 128), torch.float32), boxes, (2, 1, 64, 64))
    # the conv: plain, fused, and as the dX route calls it (the cotangent as activations, the rotated weights)
    conv_before = conv_cmajor_cuda.launches
    xf = _CudaTyped((2, 6, 10 * 16), torch.bfloat16)
    w = _CudaTyped((3, 3, 6, 5), torch.bfloat16)
    shift = _CudaTyped((5,), torch.float32)
    for args in ((xf, w, None, 8, 16), (xf, w, shift, 8, 16),
                 (_CudaTyped((2, 5, 10 * 16), torch.bfloat16),
                  _CudaTyped((3, 3, 5, 6), torch.bfloat16), None, 8, 16)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            conv_cmajor_cuda.conv_flat_cuda(*args)
    assert ctc_cuda.launches == ctc_cuda.bwd_launches == 0
    assert gather_cuda.launches == gather_cuda.bwd_launches == 0
    assert conv_cmajor_cuda.launches == conv_before


def test_conv_dispatch_sends_a_cuda_tensor_to_the_kernel(monkeypatch):
    """`ops/conv_cmajor.py` chooses by the tensor's device alone: a tensor
    that says it lies on a CUDA device goes to the kernel's wrapper, forward
    and (through the autograd function's backward) for dX, never to the
    plain version."""
    from qea_ocr_tpu_torch.ops import conv_cmajor as cc

    seen = []

    def fake_kernel(xf, w, shift, height, width):
        seen.append((tuple(w.shape), shift is not None))
        return torch.zeros((xf.shape[0], w.shape[3], xf.shape[2]),
                           dtype=torch.bfloat16)

    class OnCuda(torch.Tensor):
        device = torch.device("cuda", 0)

    monkeypatch.setattr(cc.conv_cmajor_cuda, "conv_flat_cuda", fake_kernel)
    monkeypatch.setattr(cc, "conv_flat_plain", lambda *a, **k: pytest.fail(
        "the plain version ran for a CUDA tensor"))
    xf = torch.zeros((1, 6, 5 * 4), dtype=torch.bfloat16).as_subclass(OnCuda)
    w = torch.zeros((3, 3, 6, 5))
    cc._conv_flat(xf, w, None, 3, 4)
    cc._conv_flat(xf, w, torch.zeros(5), 3, 4)
    cc._conv_flat(torch.zeros((1, 5, 20), dtype=torch.bfloat16
                              ).as_subclass(OnCuda), cc._rot_w(w), None, 3, 4)
    assert seen == [((3, 3, 6, 5), False), ((3, 3, 6, 5), True),
                    ((3, 3, 5, 6), False)]
    with pytest.raises(ValueError, match="no channel-major conv"):
        class OnMeta(torch.Tensor):
            device = torch.device("meta")
        cc._conv_flat(torch.zeros((1, 6, 20)).as_subclass(OnMeta), w, None,
                      3, 4)
