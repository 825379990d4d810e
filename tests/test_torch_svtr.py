"""SVTR as the port's proxy (`qea_ocr_tpu_torch/models/svtr.py`), on the
CPU at a tiny preset: an 8x32 grid from a 32x128 crop, so that windows
clip at the edges, three stages with the switch from local to global
blocks inside the second. The plain reference is the benchmark's
(`portbench/reference/svtr.py`); weights are the benchmark's from a seed.
"""

import pytest
import torch

from portbench.reference import ops as O
from portbench.reference import svtr as S
from portbench.reference.precision import fp8_e4m3
from portbench.weights import make_state
from portbench.weights_svtr import svtr_schema
from qea_ocr_tpu_torch.models import svtr
from qea_ocr_tpu_torch.models.svtr import SVTR
from qea_ocr_tpu_torch.utils import metrics

DEV = torch.device("cpu")
V = 95
TINY = dict(dims=(64, 64, 64), depths=(2, 2, 1), heads=(2, 2, 2),
            local_blocks=3, out_channels=32, window=(7, 11), mlp_ratio=4)
# bfloat16 operands carry 8 significant bits (a relative rounding of
# 2^-9 each); through the tiny model's 17 matmuls, its softmaxes and
# LayerNorms the port's bfloat16 run lies 0.026 from the float32 reference
# in the largest log-prob and 1.5% in the worst gradient (a norm bias,
# and the input's); float8 (e4m3, 4 significant bits) lies 0.29 and 18%
# off. The limits sit between, with 3-4x room on each side.
LOGPROB_TOL = 0.08
GRAD_TOL = 0.06


def _state(seed=7):
    return make_state(svtr_schema(TINY, V), seed, 2, DEV)


def _port(dt):
    m = SVTR(V, compute_dtype=dt, **TINY)
    m.load_state_dict(_state(), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def batch():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(6, 1, 32, 128, generator=g)
    labels = torch.randint(1, V, (6, 100), generator=g, dtype=torch.int32)
    lengths = torch.randint(3, 13, (6,), generator=g, dtype=torch.int32)
    return x, labels, lengths


def _port_run(dt, batch):
    x, labels, lengths = batch
    m = _port(dt)
    xi = x.clone().requires_grad_(True)
    lp = m(xi)
    loss = O.ctc_nll(lp, labels, lengths).mean()
    names = ["input"] + [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, [xi, *m.parameters()])
    return lp.detach(), dict(zip(names, grads))


def _ref_run(batch, q=lambda t: t):
    x, labels, lengths = batch
    sd = _state()
    names = [n for n, v in sd.items()
             if v.dtype.is_floating_point and "running" not in n]
    for n in names:
        sd[n].requires_grad_(True)
    xi = x.clone().requires_grad_(True)
    lp = S.svtr(xi, sd, TINY, q)
    loss = O.ctc_nll(lp, labels, lengths).mean()
    grads = torch.autograd.grad(loss, [xi] + [sd[n] for n in names])
    return lp.detach(), dict(zip(["input"] + names, grads))


@pytest.fixture(scope="module")
def reference(batch):
    return _ref_run(batch)


def _gaps(got, want):
    """(largest log-prob gap, worst relative gradient error)."""
    (lp, g), (ref_lp, ref_g) = got, want
    assert lp.shape == (32, 6, V)
    assert set(g) == set(ref_g)
    return float((lp - ref_lp).abs().max()), max(
        float((g[k] - ref_g[k]).norm() / ref_g[k].norm())
        for k in ref_g if ref_g[k].norm() > 0)


def test_float32_matches_the_reference(batch, reference):
    lp_gap, grad_gap = _gaps(_port_run(torch.float32, batch), reference)
    assert lp_gap < 1e-4 and grad_gap < 1e-4


def test_bfloat16_within_tolerance_and_float8_is_not(batch, reference):
    lp_gap, grad_gap = _gaps(_port_run(torch.bfloat16, batch), reference)
    assert lp_gap < LOGPROB_TOL and grad_gap < GRAD_TOL
    lp_gap, grad_gap = _gaps(_ref_run(batch, fp8_e4m3), reference)
    assert lp_gap > LOGPROB_TOL and grad_gap > GRAD_TOL


def test_window_mask_is_the_clipped_window():
    mask = svtr.window_mask(8, 32, (7, 11), DEV, torch.float32)
    assert mask is svtr.window_mask(8, 32, (7, 11), DEV, torch.float32)
    torch.testing.assert_close(mask, S.window_mask(8, 32, (7, 11), DEV))
    seen = (mask == 0).reshape(8, 32, 8, 32)
    for r, c in ((0, 0), (3, 13), (7, 31), (2, 30)):
        rows = [rr for rr in range(8) if abs(rr - r) <= 3]
        cols = [cc for cc in range(32) if abs(cc - c) <= 5]
        want = torch.zeros(8, 32, dtype=torch.bool)
        want[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = True
        assert torch.equal(seen[r, c], want)
    assert int(seen[0, 0].sum()) == 4 * 6      # a corner query
    assert int(seen[3, 13].sum()) == 7 * 11    # away from every edge
    assert torch.isneginf(mask[mask != 0]).all()


def test_spans_cover_each_run_and_its_backward():
    m = _port(torch.float32)
    x = torch.rand(2, 1, 32, 128, requires_grad=True)
    with metrics.recording():
        m(x).sum().backward()
    spans = metrics.drain()
    by_id = {s.id: s for s in spans}
    names = [s.name for s in spans]
    # stage 1 local; stage 2 local then global; stage 3 global
    assert names.count("svtr.local") == 2 and names.count("svtr.global") == 2
    assert names.count("svtr.local.backward") == 2
    assert names.count("svtr.global.backward") == 2
    for s in spans:
        if s.name.startswith("svtr.") and s.name.endswith(".backward") \
                and s.name != "svtr.backward":
            assert by_id[s.parent].name == "svtr.backward"
            assert s.end_ns > s.start_ns
    runs = [s for s in spans if s.mark and s.parent is not None]
    # the backwards follow one another, none inside another
    for a, b in zip(runs, runs[1:]):
        assert a.end_ns <= b.start_ns


def _tiny_models():
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.train.state import adam_l2
    unet = UNet(init_features=4)
    proxy = SVTR(V, **TINY)
    return (unet, proxy, adam_l2(unet.parameters(), 1e-4, 0.0),
            adam_l2(proxy.parameters(), 1e-4, 0.0))


def test_area_and_patch_steps_run_with_svtr():
    from qea_ocr_tpu_torch.train.area_trainer import make_area_steps
    from qea_ocr_tpu_torch.train.patch_steps import make_steps
    from qea_ocr_tpu_torch.utils.charmap import CharMap
    cm = CharMap.default()
    g = torch.Generator().manual_seed(3)
    unet, proxy, opt_u, opt_c = _tiny_models()
    B, W = 4, 2
    images = torch.rand(B, 1, 32, 128, generator=g)
    labels = torch.randint(1, cm.pad_id, (B, cm.max_len), generator=g,
                           dtype=torch.int32)
    lengths = torch.full((B,), 5, dtype=torch.int32)
    labels[:, 5:] = cm.pad_id
    ids = torch.arange(B, dtype=torch.int32)
    cer, ent = torch.ones(B), torch.ones(B)
    area = make_area_steps(unet, proxy, cm, prep_optimizer=opt_u,
                           crnn_optimizer=opt_c)
    steps = make_steps(unet, proxy, cm, crnn_optimizer=opt_c)
    preds = area.prep_forward(images)
    mask = torch.tensor([True, False, True, True])
    valid = mask[:, None].expand(B, W).clone()
    before = proxy.head.weight.detach().clone()
    loss_a = steps.phase_a(
        preds, mask, labels[:, None].expand(B, W, -1), lengths[:, None]
        .expand(B, W), valid, torch.tensor([1.0, 0.7]), preds[None],
        labels[None], lengths[None], decaying=True, inner_limit_skip=True)
    assert torch.isfinite(loss_a) and not torch.equal(before,
                                                      proxy.head.weight)
    _, m, cer, ent = area.phase_b(images, labels, cer, ent, lengths, ids,
                                  update_crnn=False)
    # the tables hold each crop's CER of the decode (written over the 1s)
    assert torch.isfinite(m["loss"]) and not torch.equal(cer, torch.ones(B))
    # the patch step: two 64x144 documents, three strip slots each
    D, S = 2, 3
    docs = torch.rand(D, 1, 64, 144, generator=g)
    boxes = torch.tensor([[[0, 0, 60, 20], [30, 30, 140, 60],
                           [5, 5, 20, 15]]] * D, dtype=torch.int32)
    smask = torch.ones(D, S, dtype=torch.bool)
    pl = labels[:1].expand(D * S, -1)
    plen = lengths[:1].expand(D * S)
    steps = make_steps(unet, proxy, cm, prep_optimizer=opt_u,
                       crnn_optimizer=opt_c)
    _, strips = steps.prep_extract(docs, boxes)
    flat = smask.reshape(-1)
    out = steps.phase_ab(
        docs, boxes, smask, pl.reshape(D, S, -1), torch.ones(D * S),
        torch.ones(D * S), plen.reshape(D, S),
        torch.arange(D * S, dtype=torch.int32).reshape(D, S), strips, flat,
        pl[:, None], plen[:, None], flat[:, None], torch.tensor([1.0]),
        strips[None], pl[None], plen[None], decaying=True,
        inner_limit_skip=True, update_crnn=False)
    assert torch.isfinite(out[-1]) and out[1]["decoded"].shape == (D * S, 32)


def _svtr_l_parameters(vocab: int) -> int:
    """SVTR-L's parameter count from its published widths: the patch
    embedding (two convs without bias and their norms), the position
    table on the 8x32 grid, 12 d^2 + 13 d a block, the two merges (conv
    with bias, LN), the last LN, the 1x1 conv and the head."""
    dims, depths = (192, 256, 512), (3, 9, 9)
    n = 9 * 96 + 2 * 96 + 9 * 96 * 192 + 2 * 192 + 256 * 192
    n += sum(k * (12 * d * d + 13 * d) for d, k in zip(dims, depths))
    n += (9 * 192 * 256 + 256 + 2 * 256) + (9 * 256 * 512 + 512 + 2 * 512)
    n += 2 * 512 + 512 * 384 + 384 * vocab + vocab
    return n


@pytest.mark.parametrize("cli", ["area_cli", "patch_cli", "train_crnn"])
def test_proxy_flag_builds_the_published_svtr_l(cli, tmp_path):
    import importlib
    mod = importlib.import_module(f"qea_ocr_tpu_torch.cli.{cli}")
    argv = ["--device", "cpu", "--dataset", "synthetic", "--ocr", "Fake",
            "--proxy", "svtr-l"]
    sizes = {"area_cli": ["--synthetic_train_size", "4",
                          "--synthetic_val_size", "2", "--unet_features",
                          "4", "--exp_base_path", str(tmp_path)],
             "patch_cli": ["--synthetic_train_docs", "2",
                           "--synthetic_val_docs", "1", "--unet_features",
                           "4", "--doc_size", "64", "144",
                           "--exp_base_path", str(tmp_path)],
             "train_crnn": ["--synthetic_train_size", "4",
                            "--synthetic_val_size", "2",
                            "--crnn_model_path", str(tmp_path / "m")]}
    cfg = mod.config_from_args(mod.build_parser().parse_args(
        argv + sizes[cli]))
    assert cfg.proxy == "svtr-l"
    if cli == "area_cli":
        from qea_ocr_tpu_torch.train.area_trainer import TrainNNPrepArea
        model = TrainNNPrepArea(cfg).crnn_model
    elif cli == "patch_cli":
        from qea_ocr_tpu_torch.train.patch_trainer import TrainNNPrep
        model = TrainNNPrep(cfg).crnn_model
    else:
        from qea_ocr_tpu_torch.train.crnn_trainer import TrainCRNN
        model = TrainCRNN(cfg).model
    assert isinstance(model, SVTR)
    assert sum(p.numel() for p in model.parameters()) \
        == _svtr_l_parameters(model.head.out_features) \
        == (38_888_895 if model.head.out_features == 95 else None)
    assert [len(s) for s in model.stages] == [3, 9, 9]
    assert [b.local for s in model.stages for b in s] \
        == [True] * 10 + [False] * 11
    assert [s[0].mixer.heads for s in model.stages] == [6, 8, 16]


def test_ctc_kernels_take_svtr_steps():
    """T = 32 at L = 100: both kernels' band is three warps and the
    backward's shared memory is far inside what a block may have, so the
    CTC kernels take SVTR's scores unchanged."""
    from qea_ocr_tpu_torch.ops.cuda import ctc_cuda
    assert ctc_cuda.band_threads(32, 100) == 96
    smem = ctc_cuda.grad_smem_bytes(32, V, 100)
    assert smem == 37_824 and smem <= ctc_cuda.GRAD_MAX_SMEM
    assert 2 * 100 + 1 <= ctc_cuda.MAX_EXTENDED
    lp = torch.log_softmax(torch.randn(32, 3, V), -1)
    labels = torch.randint(1, V, (3, 100), dtype=torch.int32)
    lengths = torch.tensor([3, 12, 30], dtype=torch.int32)
    # every limit passes; on the CPU only the device is refused
    with pytest.raises(ValueError, match="CUDA tensors"):
        ctc_cuda._check(lp, labels, lengths, grad=True)
