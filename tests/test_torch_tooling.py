"""The port's pruning, CER analysis, dataset builder and sweeps
(`qea_ocr_tpu_torch/pruning/`, `tools/prune_cli.py`, `tools/cer_analysis.py`,
`tools/build_patch_dataset.py`, `sweeps/sweep.py`) against the JAX package's,
on the CPU: the same seeded inputs through both, and the same output bytes
where the JAX function is plain numpy. One repair is held apart:
`pruning_indices` also matches a document by the key `doc_mean_cers` groups
its strips under, which the JAX package misses where a file name holds a
'_' (the synthetic world's); everywhere else the two agree.

The trainers' hooks: `_maybe_optuna` of both trainers against the JAX
trainers' (called unbound, so no flax init runs), and the random search
end to end on the JAX tests' tiny worlds (`tests/test_tools.py`).
"""

import contextlib
import importlib
import io
import json
import os
import sys
import types

import numpy as np
import pytest

from qea_ocr_tpu.pruning import prune as j_prune
from qea_ocr_tpu.sweeps import sweep as j_sweep
from qea_ocr_tpu.tools import build_patch_dataset as j_build
from qea_ocr_tpu.tools import cer_analysis as j_analysis
from qea_ocr_tpu.tools import prune_cli as j_prune_cli
from qea_ocr_tpu_torch.pruning import prune as t_prune
from qea_ocr_tpu_torch.sweeps import sweep as t_sweep
from qea_ocr_tpu_torch.tools import build_patch_dataset as t_build
from qea_ocr_tpu_torch.tools import cer_analysis as t_analysis
from qea_ocr_tpu_torch.tools import prune_cli as t_prune_cli

from _torch_parity import RecordingTrial, trial_pruned_type


def _strip_cers(seed, n_docs=12, folders=("f", "g")):
    """Strip-level CERs in the reference key format
    '{j}_{label}_{folder}_{file}', several strips a document."""
    rng = np.random.default_rng(seed)
    out = {}
    for d in range(n_docs):
        folder = folders[d % len(folders)]
        for j in range(int(rng.integers(1, 5))):
            out[f"{j}_W{j}_{folder}_d{d}"] = float(rng.random())
    return out


@pytest.fixture(scope="module")
def cers():
    return _strip_cers(0)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_doc_means_and_topk(cers):
    got, want = t_prune.doc_mean_cers(cers), j_prune.doc_mean_cers(cers)
    assert got == want and len(want) == 12
    for k in (0, 3, 12, 20):
        assert t_prune.topk(got, k) == j_prune.topk(want, k)


@pytest.mark.parametrize("k", [1, 4, 7, 12])
def test_facility_location(cers, k):
    means = t_prune.doc_mean_cers(cers)
    got, want = t_prune.facility_location(means, k), \
        j_prune.facility_location(means, k)
    assert list(got.items()) == list(want.items())
    x = np.asarray(list(means.values()))
    sim = (x.max() - x.min()) - np.abs(x[:, None] - x[None, :])

    def objective(chosen):
        idx = [list(means).index(n) for n in chosen]
        return float(sim[idx].max(axis=0).sum())
    assert objective(got) == objective(want)


def test_pruning_indices_and_artifacts(tmp_path, cers):
    from qea_ocr_tpu.data.datasets import PatchDocuments as JDocs
    from qea_ocr_tpu_torch.data.datasets import PatchDocuments as TDocs

    for method in ("topk", "FL"):
        tp = t_prune.DatasetPruner(cers, method, 5)
        jp = j_prune.DatasetPruner(cers, method, 5)
        a = tp.save(str(tmp_path / "t"), method)
        b = jp.save(str(tmp_path / "j"), method)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert t_prune.load_artifact(a) == j_prune.load_artifact(b)
    # documents whose '{folder}_{file}' keys hold no '_' of their own: the
    # same indices as the JAX package
    kw = dict(seed=4, n_strips=2, max_strips=4, doc_size=(96, 128))
    jd, td = JDocs.synthetic(6, **kw), TDocs.synthetic(6, **kw)
    keys = [s.doc_name.replace(os.sep, "_") for s in jd.samples]
    art = tmp_path / "keys.json"
    art.write_text(json.dumps({keys[i]: 0.5 for i in (4, 0, 5)}))
    np.testing.assert_array_equal(t_prune.pruning_indices(td, str(art)),
                                  j_prune.pruning_indices(jd, str(art)))
    np.testing.assert_array_equal(t_prune.pruning_indices(td, str(art)),
                                  [0, 4, 5])


def test_pruning_indices_on_the_grouped_keys(tmp_path):
    """An artifact made by `doc_mean_cers` from the synthetic world's strip
    names keys `synth/doc_00003` as `doc_00003`: the port keeps those
    documents, the JAX package none (its defect, left as it is)."""
    from qea_ocr_tpu.data.datasets import PatchDocuments as JDocs
    from qea_ocr_tpu_torch.data.datasets import PatchDocuments as TDocs

    kw = dict(seed=5, n_strips=3, max_strips=4, doc_size=(96, 128))
    jd, td = JDocs.synthetic(5, **kw), TDocs.synthetic(5, **kw)
    strip_cers = {n: 0.1 * d for d, s in enumerate(td.samples)
                  for n in s.strip_names if n}
    kept = t_prune.topk(t_prune.doc_mean_cers(strip_cers), 2)
    assert set(kept) == {"doc_00004", "doc_00003"}
    art = tmp_path / "grouped.json"
    art.write_text(json.dumps(kept))
    np.testing.assert_array_equal(t_prune.pruning_indices(td, str(art)),
                                  [3, 4])
    assert j_prune.pruning_indices(jd, str(art)).size == 0


@pytest.mark.parametrize("method", ["topk", "FL"])
def test_prune_cli_bytes(tmp_path, cers, method):
    src = tmp_path / "cers.json"
    src.write_text(json.dumps(cers))
    outs = []
    for main, side in ((t_prune_cli.main, "t"), (j_prune_cli.main, "j")):
        printed = _run(main, ["--cers", str(src), "--method", method,
                              "--num_samples", "4", "--out_dir",
                              str(tmp_path / side), "--artifact_name", "art"])
        outs.append((printed.replace(str(tmp_path / side), "<dir>"),
                     (tmp_path / side / "art.json").read_bytes()))
    assert outs[0] == outs[1]
    assert len(json.loads(outs[0][1])) == 4


def test_cer_analysis_bytes(tmp_path, cers):
    src = tmp_path / "cers.json"
    src.write_text(json.dumps(cers))
    tree = tmp_path / "docs"
    for folder in ("f", "g"):
        (tree / folder).mkdir(parents=True)
    for d in range(12):
        folder = "fg"[d % 2]
        (tree / folder / f"d{d}.png").write_bytes(b"png %d" % d)
        (tree / folder / f"d{d}.json").write_text("[]")
    outs = []
    for main, side in ((t_analysis.main, "t"), (j_analysis.main, "j")):
        printed = _run(main, ["--cers", str(src), "--threshold", "0.4",
                              "--summary_out", str(tmp_path / f"{side}.json"),
                              "--src_dir", str(tree), "--out_dir",
                              str(tmp_path / side)])
        split = sorted(str(p.relative_to(tmp_path / side))
                       for p in (tmp_path / side).rglob("*"))
        outs.append((printed, (tmp_path / f"{side}.json").read_bytes(),
                     split))
    assert outs[0] == outs[1]
    summary = json.loads(outs[0][1])
    assert summary["count"] == 12
    assert summary["easy_docs"] + summary["hard_docs"] == 12
    means = t_prune.doc_mean_cers(cers)
    assert t_analysis.cer_summary(means) == j_analysis.cer_summary(means)
    assert t_analysis.split_by_threshold(means, 0.3) \
        == j_analysis.split_by_threshold(means, 0.3)


def test_build_patch_dataset_sidecars(tmp_path):
    from PIL import Image

    from qea_ocr_tpu.ocr.gvision import GVisionBackend as JGVision
    from qea_ocr_tpu_torch.data.datasets import PatchDocuments
    from qea_ocr_tpu_torch.ocr.gvision import GVisionBackend as TGVision

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate(((100, 150), (64, 256))):
        Image.fromarray((rng.random((h, w)) * 255).astype(np.uint8), "L").save(
            raw / f"doc{i}.png")
    n_t = t_build.build(str(raw), str(tmp_path / "t"),
                        TGVision(mock_response=True))
    n_j = j_build.build(str(raw), str(tmp_path / "j"),
                        JGVision(mock_response=True))
    assert n_t == n_j == 2
    for i in range(2):
        for ext in (".json", ".png"):
            assert (tmp_path / "t" / f"doc{i}{ext}").read_bytes() \
                == (tmp_path / "j" / f"doc{i}{ext}").read_bytes()
    sidecar = json.loads((tmp_path / "t" / "doc0.json").read_text())
    assert sidecar == [dict(label="MOCK", x_min=0, y_min=0, x_max=127,
                            y_max=31)]
    # the main's output and the dataset the port reads back
    printed = _run(t_build.main, ["--src", str(raw), "--dst",
                                  str(tmp_path / "m"), "--mock"])
    assert printed == f"annotated 2 documents -> {tmp_path / 'm'}\n"
    ds = PatchDocuments(str(tmp_path / "t"), max_strips=4)
    assert len(ds) == 2 and all(s.strip_mask.sum() == 1 for s in ds.samples)


def test_random_trial_suggests_as_jax():
    jr, tr = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        jt, tt = j_sweep._RandomTrial(jr), t_sweep._RandomTrial(tr)
        for t in (jt, tt):
            t.suggest_float("lr", 1e-5, 1e-3, log=True)
            t.suggest_float("m", 0.1, 0.9)
            t.suggest_int("std", 1, 10)
            t.report(1.0, 0)
        assert tt.params == jt.params
        assert tt.should_prune() is jt.should_prune() is False


def test_optuna_guard_takes_the_random_search(monkeypatch):
    """A stub `optuna` with `TrialPruned` only (the reference shims') is no
    usable optuna: the sweep keeps to the random search, as JAX's does."""
    stub = types.ModuleType("optuna")
    stub.TrialPruned = type("TrialPruned", (Exception,), {})
    monkeypatch.setitem(sys.modules, "optuna", stub)
    try:
        for mod in (t_sweep, j_sweep):
            importlib.reload(mod)
            assert mod.HAVE_OPTUNA is False
    finally:
        monkeypatch.delitem(sys.modules, "optuna")
        for mod in (t_sweep, j_sweep):
            importlib.reload(mod)
    assert t_sweep.HAVE_OPTUNA == j_sweep.HAVE_OPTUNA


@pytest.mark.parametrize("trainer", ["patch", "area"])
def test_maybe_optuna_as_jax(trainer):
    """The same reports, then the same exception, from a trial that prunes
    after epoch 1; no trial: nothing."""
    if trainer == "patch":
        from qea_ocr_tpu.train.patch_trainer import TrainNNPrep as J
        from qea_ocr_tpu_torch.train.patch_trainer import TrainNNPrep as T
    else:
        from qea_ocr_tpu.train.area_trainer import TrainNNPrepArea as J
        from qea_ocr_tpu_torch.train.area_trainer import TrainNNPrepArea as T
    seen = []
    for cls in (J, T):
        trial = RecordingTrial(prune_after=1)
        host = types.SimpleNamespace(cfg=types.SimpleNamespace(
            optuna_trial=trial))
        cls._maybe_optuna(host, 37.5, 0)
        with pytest.raises(trial_pruned_type()) as e:
            cls._maybe_optuna(host, 41.25, 1)
        seen.append((trial.reports, type(e.value), str(e.value)))
        none = types.SimpleNamespace(cfg=types.SimpleNamespace(
            optuna_trial=None))
        assert cls._maybe_optuna(none, 50.0, 2) is None
    assert seen[0] == seen[1]
    assert seen[1][0] == [(37.5, 0), (41.25, 1)]


PATCH_WORLD = dict(
    synthetic_train_docs=2, synthetic_val_docs=1,
    synthetic_strips_per_doc=2, max_strips=2, batch_docs=2,
    doc_size=(96, 128), lstm_hidden=16, unet_features=4,
    inner_limit=1, minibatch_subset="random", minibatch_subset_prop=0.5,
    corruption=dict(noise_std=0.05, shading=0.0, salt_pepper=0.0))
CRNN_WORLD = dict(
    synthetic_train_size=16, synthetic_val_size=8, lstm_hidden=32,
    batch_size=8,
    corruption=dict(noise_std=0.02, shading=0.0, salt_pepper=0.0))


@pytest.mark.parametrize("which", ["patch", "crnn"])
def test_run_sweep_random_search(tmp_path, which):
    """Two trials of the random search on the JAX tests' tiny worlds, on the
    CPU: the best of the seed-0 suggestions."""
    if which == "patch":
        base = dict(epochs=1, ocr="Fake", dataset="synthetic",
                    exp_base_path=str(tmp_path / "exp"), device="cpu",
                    **PATCH_WORLD)
    else:
        base = dict(epochs=1, ocr="Fake", dataset="synthetic",
                    crnn_model_path=str(tmp_path / "m"), device="cpu",
                    **CRNN_WORLD)
    result = t_sweep.run_sweep(which, n_trials=2, storage=None,
                               study_name="t", acc_floor=0.0,
                               warmup_epochs=0, base_kwargs=base)
    rng = np.random.default_rng(0)
    suggested = []
    for _ in range(2):
        trial = j_sweep._RandomTrial(rng)
        if which == "patch":
            trial.suggest_float("lr_crnn", 5e-6, 5e-4, log=True)
            trial.suggest_float("lr_prep", 5e-6, 5e-4, log=True)
        else:
            trial.suggest_float("lr", 1e-5, 1e-3, log=True)
            trial.suggest_int("std", 1, 10)
        suggested.append(trial.params)
    assert set(result) == {"best_value", "best_params"}
    assert result["best_params"] in suggested
    assert 0.0 <= result["best_value"] <= 100.0


@pytest.mark.parametrize("which", ["patch", "crnn"])
def test_sweep_main(tmp_path, capsys, which):
    """`main` with `--device cpu`: both `--which` branches, `--world_json`,
    `--out`; the CRNN branch checkpoints under `exp_base_path/model*`."""
    world = PATCH_WORLD if which == "patch" else CRNN_WORLD
    out = tmp_path / "result.json"
    t_sweep.main(["--which", which, "--n_trials", "1", "--epoch", "1",
                  "--device", "cpu", "--exp_base_path", str(tmp_path / "exp"),
                  "--world_json", json.dumps(world), "--out", str(out)])
    result = json.loads(out.read_text())
    assert json.loads(
        capsys.readouterr().out.strip().splitlines()[-1]) == result
    keys = {"lr_crnn", "lr_prep"} if which == "patch" else {"lr", "std"}
    assert set(result["best_params"]) == keys
    if which == "crnn":
        import glob
        assert glob.glob(str(tmp_path / "exp" / "model*"))
