"""One rank of a CPU (Gloo) world for the port's data- and tensor-parallel
tests (`test_torch_dp.py`, `test_torch_multihost.py`,
`test_torch_parallel.py`).

Usage: python tests/_torch_dp_worker.py <mode> <rank> <world> <port> <out_dir>

Each rank joins the world through the port's own entry
(`parallel.multihost.maybe_init_distributed` with the `QEA_*` variables),
runs the cases of its `mode` and writes `<out_dir>/<mode>_<rank>.json`:
one entry per case, each the readings the tests assert on (or the error
that case raised). Rank 0 also runs each step's single-process reference
on the union of the ranks' rows. Small shapes: UNet f=4, LSTM 16, 96x128
documents, float32 models, one thread a process.

  dp  (2 ranks): `phase_ab` of the patch steps (unequal selected and valid
      counts per rank), the warmup's train step, the area path's `phase_b`
      and `prep_pretrain_step`, each against the single-process step on the
      union batch; the warmup and area trainers for an epoch; an
      indivisible batch; `clean_docs --data_parallel`.
  mh  (2 ranks): the patch trainer for an epoch with `data_parallel`, then
      with `tensor_parallel=2`.
  tp4 (4 ranks): `put_tp` on a 2x2 mesh and the two-phase step against the
      single-process step.
"""

import faulthandler
import hashlib
import json
import os
import sys
import traceback

faulthandler.dump_traceback_later(int(os.environ.get("QEA_TEST_TIMEOUT",
                                                     "240")), exit=True)

MODE, RANK, WORLD, PORT, OUT = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.update(QEA_DISTRIBUTED="1", QEA_COORDINATOR=f"127.0.0.1:{PORT}",
                  QEA_NUM_PROCESSES=str(WORLD), QEA_PROCESS_ID=str(RANK))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from qea_ocr_tpu_torch.parallel.multihost import (  # noqa: E402
    all_gather_objects, maybe_init_distributed)

CM = None
SEEDS = (7, 8)
LR, WD = 1e-3, 5e-4
FEATURES, HIDDEN, DOC = 4, 16, (96, 128)
WORLD_GROUP = None


def charmap():
    global CM
    if CM is None:
        from qea_ocr_tpu_torch.utils.charmap import CharMap
        CM = CharMap.default()
    return CM


def models():
    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
    unet = UNet(init_features=FEATURES, compute_dtype=torch.float32,
                conv_impl="xla",
                generator=torch.Generator().manual_seed(SEEDS[0]))
    crnn = CRNN(charmap().vocab_size, lstm_hidden=HIDDEN,
                compute_dtype=torch.float32,
                generator=torch.Generator().manual_seed(SEEDS[1]))
    return unet, crnn


def digest(tensors) -> str:
    """A hash of the exact bytes of `tensors` (a list)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def state_tensors(*objs):
    """Every parameter, buffer and optimizer state tensor of the models
    and optimizers in `objs`, and any tensor in it, in a fixed order."""
    from torch.distributed.tensor import DTensor
    out = []
    for o in objs:
        if isinstance(o, torch.nn.Module):
            out += [v for _, v in sorted(o.state_dict().items())]
        elif isinstance(o, torch.optim.Optimizer):
            for group in o.param_groups:
                for p in group["params"]:
                    st = o.state.get(p, {})
                    out += [st[k] for k in sorted(st)
                            if isinstance(st[k], torch.Tensor)]
        else:
            out.append(o)
    return [t.to_local() if isinstance(t, DTensor) else t for t in out]


def same_on_every_rank(*objs) -> bool:
    return len(set(all_gather_objects(digest(state_tensors(*objs))))) == 1


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def whole_params(model) -> dict:
    """Every parameter of `model` whole, on the host (gathering shards is a
    collective: every rank of the mesh calls)."""
    from qea_ocr_tpu_torch.parallel.tp import full_tensor
    return {n: full_tensor(p.detach()).cpu().numpy()
            for n, p in model.named_parameters()}


def param_diffs(model, ref_model, wd=WD):
    """`model` (or its `whole_params`): largest |param - ref| after one step from equal parameters, over the
    entries where Adam's first step, lr * g / (|g| + 1e-8), does not hinge
    on float32 noise (see tests/test_torch_train_step.py): those whose
    decayed gradient g in the reference step exceeds a hundredth of its
    tensor's largest and 1e-6 (well above Adam's eps), in tensors whose
    largest exceeds 1e-5 of the model's (a conv bias before a train-mode
    batch norm has the true gradient 0: all noise). Returns that, the share
    of entries held and the worst tensor's name."""
    ref = dict(ref_model.named_parameters())
    decayed = {n: np.abs(r.grad.numpy() + wd * r.detach().numpy())
               for n, r in ref.items() if r.grad is not None}
    top = max(float(d.max()) for d in decayed.values())
    worst, held, total, name = 0.0, 0, 0, ""
    whole = model if isinstance(model, dict) else whole_params(model)
    for n, got in whole.items():
        want = ref[n].detach().cpu().numpy()
        total += want.size
        if n not in decayed or decayed[n].max() <= 1e-5 * top:
            continue
        sure = (decayed[n] > 1e-2 * decayed[n].max()) & (decayed[n] > 1e-6)
        held += int(sure.sum())
        err = float(np.abs(got - want)[sure].max(initial=0.0))
        if err > worst:
            worst, name = err, n
    return worst, held / max(1, total), name


def buffer_diff(model, ref_model) -> float:
    ref = dict(ref_model.named_buffers())
    return max((float((b.float() - ref[n].float()).abs().max())
                for n, b in model.named_buffers()
                if "running" in n), default=0.0)


# ----------------------------------------------------------------- the data
def patch_batch(n_docs=4, seed=0, W=2, I=1):
    """The union batch of the patch-step case: documents, boxes, labels,
    the selection, label histories with per-sample weights and one jitter
    copy. The first half of the documents (rank 0's) have 5 selected strips
    and two-deep histories, the second half 1 and one-deep."""
    from qea_ocr_tpu_torch.data import PatchDocuments, collate_docs
    cm = charmap()
    L = cm.max_len
    docs = PatchDocuments.synthetic(n_docs, seed=seed, n_strips=3,
                                    max_strips=4, doc_size=DOC)
    b = collate_docs(list(docs))
    D, S = b.strip_mask.shape
    N = D * S
    rng = np.random.default_rng(seed + 1)
    half = N // 2
    sel = np.zeros(N, bool)
    valid_rows = np.nonzero(b.strip_mask.reshape(N))[0]
    first = valid_rows[valid_rows < half][:5]
    second = valid_rows[valid_rows >= half][:1]
    sel[first] = True
    sel[second] = True
    hist = np.full((N, W, L), cm.pad_id, np.int32)
    hist[:, :, :4] = rng.integers(1, cm.vocab_size, (N, W, 4))
    hist_len = np.full((N, W), 4, np.int32)
    hv = np.zeros((N, W), bool)
    hv[:, 0] = sel
    hv[:half, 1] = sel[:half]
    lw = rng.random((N, W + 1)).astype(np.float32)
    jl = np.full((I, N, L), cm.pad_id, np.int32)
    jl[..., :3] = rng.integers(1, cm.vocab_size, (I, N, 3))
    return dict(batch=b, N=N, S=S, bb_mask=sel, hist_labels=hist,
                hist_lengths=hist_len, hist_valid=hv, loss_weights=lw,
                jitter_noise=rng.normal(0, 0.05, (I, N, 1, 32, 128)).astype(
                    np.float32),
                jitter_labels=jl, jitter_lengths=np.full((I, N), 3, np.int32),
                table=rng.random(docs.num_strips + 3).astype(np.float32))


def run_patch_step(b, rows_docs, group, unet, crnn, tp_mesh=None):
    """`prep_extract` + `phase_ab` on the documents `rows_docs` (a slice)
    of the union batch `b`; returns the readings and the objects."""
    from qea_ocr_tpu_torch.train.patch_steps import make_steps
    from qea_ocr_tpu_torch.train.state import adam_l2
    batch = b["batch"]
    S = b["S"]
    rows = slice(rows_docs.start * S, rows_docs.stop * S)
    sharded = tp_mesh is not None
    po = adam_l2(unet.parameters(), LR, WD, sharded=sharded)
    co = adam_l2(crnn.parameters(), LR, WD, sharded=sharded)
    if sharded:
        from qea_ocr_tpu_torch.parallel.tp import put_tp
        put_tp(unet, tp_mesh, po)
        put_tp(crnn, tp_mesh, co)
    twin = unet.twin("xla")
    steps = make_steps(unet, crnn, charmap(), prep_optimizer=po,
                       crnn_optimizer=co, prep_eval_model=twin, group=group)
    t = torch.from_numpy
    d = rows_docs
    cer = t(b["table"].copy())
    ent = t(b["table"].copy()[::-1].copy())
    doc_args = (t(batch.images[d]), t(batch.bboxes[d]),
                t(batch.strip_mask[d]), t(batch.gt_labels[d]), cer, ent,
                t(batch.gt_lengths[d]), t(batch.strip_ids[d]))
    _, strips = steps.prep_extract(doc_args[0], doc_args[1])
    jitter = (strips[None] - t(b["jitter_noise"][:, rows])).clamp(0, 1)
    out = steps.phase_ab(
        *doc_args, strips, t(b["bb_mask"][rows]), t(b["hist_labels"][rows]),
        t(b["hist_lengths"][rows]), t(b["hist_valid"][rows]),
        t(b["loss_weights"][rows]), jitter, t(b["jitter_labels"][:, rows]),
        t(b["jitter_lengths"][:, rows]), decaying=False,
        inner_limit_skip=True, update_crnn=False)
    _, metrics, cer, ent, loss_a = out
    return dict(loss_b=float(metrics["loss"]), loss_a=float(loss_a),
                cer=cer, ent=ent, strips=strips, unet=unet, crnn=crnn,
                po=po, co=co, twin=twin)


def case_patch_step():
    b = patch_batch()
    D = b["batch"].strip_mask.shape[0]
    dl = D // WORLD
    got = run_patch_step(b, slice(RANK * dl, (RANK + 1) * dl), WORLD_GROUP,
                         *models())
    res = dict(
        selected=[int(x) for x in all_gather_objects(
            int(b["bb_mask"][RANK * dl * b["S"]:(RANK + 1) * dl * b["S"]]
                .sum()))],
        valid_depth1=[int(x) for x in all_gather_objects(int(
            b["hist_valid"][RANK * dl * b["S"]:(RANK + 1) * dl * b["S"], 1]
            .sum()))],
        same=same_on_every_rank(got["unet"], got["crnn"], got["po"],
                                got["co"], got["cer"], got["ent"]))
    if RANK == 0:
        ref = run_patch_step(b, slice(0, D), None, *models())
        res.update(
            loss_b_rel=rel(got["loss_b"], ref["loss_b"]),
            loss_a_rel=rel(got["loss_a"], ref["loss_a"]),
            strips_abs=float((got["strips"] - ref["strips"][:dl * b["S"]])
                             .abs().max()),
            unet_params=param_diffs(got["unet"], ref["unet"]),
            crnn_params=param_diffs(got["crnn"], ref["crnn"]),
            bn_abs=buffer_diff(got["unet"], ref["unet"]),
            cer_abs=float((got["cer"] - ref["cer"]).abs().max()),
            ent_abs=float((got["ent"] - ref["ent"]).abs().max()),
            tables_moved=bool((ref["cer"] != torch.from_numpy(
                b["table"])).any()))
    return res


def word_batch(n=8, seed=3):
    from functools import partial

    from qea_ocr_tpu_torch.data.datasets import SyntheticWordDataset
    from qea_ocr_tpu_torch.data.pipeline import collate_words
    ds = SyntheticWordDataset(n, seed=seed)
    return partial(collate_words, charmap=charmap())(list(ds.samples))


def case_warmup_step():
    from qea_ocr_tpu_torch.train.crnn_trainer import (
        CrnnTrainerConfig, TrainCRNN)
    wb = word_batch()
    B = wb.images.shape[0]
    bl = B // WORLD
    t = torch.from_numpy

    def trainer(dp):
        tr = TrainCRNN(CrnnTrainerConfig(
            device="cpu", dataset="synthetic", synthetic_train_size=4,
            synthetic_val_size=2, batch_size=B, lstm_hidden=HIDDEN, lr=LR,
            data_parallel=dp, crnn_model_path=os.path.join(OUT, "unused")))
        tr.model.compute_dtype = torch.float32
        return tr

    tr = trainer(True)
    r = slice(RANK * bl, (RANK + 1) * bl)
    loss = float(tr._train_step(t(wb.images[r]), t(wb.labels[r]),
                                t(wb.lengths[r])))
    res = dict(same=same_on_every_rank(tr.model, tr.optimizer))
    if RANK == 0:
        ref = trainer(False)
        ref_loss = float(ref._train_step(t(wb.images), t(wb.labels),
                                         t(wb.lengths)))
        res.update(loss_rel=rel(loss, ref_loss),
                   params=param_diffs(tr.model, ref.model, wd=0.0),
                   bn_abs=buffer_diff(tr.model, ref.model),
                   bn_moved=bool((ref.model.convo.batchnorm1.running_mean
                                  != 0).any()))
    return res


def case_area_steps():
    from qea_ocr_tpu_torch.train.area_trainer import make_area_steps
    from qea_ocr_tpu_torch.train.state import adam_l2
    wb = word_batch(seed=4)
    B = wb.images.shape[0]
    bl = B // WORLD
    t = torch.from_numpy
    table = np.random.default_rng(5).random(B + 2).astype(np.float32)
    ids = np.random.default_rng(6).permutation(B + 2)[:B].astype(np.int32)

    def run(rows, group):
        """One `prep_pretrain_step` and, from fresh models, one `phase_b`."""
        out = {}
        for step in ("pretrain", "phase_b"):
            unet, crnn = models()
            po = adam_l2(unet.parameters(), LR, 0.0)
            co = adam_l2(crnn.parameters(), LR, 0.0)
            steps = make_area_steps(unet, crnn, charmap(), prep_optimizer=po,
                                    crnn_optimizer=co, group=group)
            images = t(wb.images[rows])
            if step == "pretrain":
                loss = float(steps.prep_pretrain_step(images))
                cer = ent = None
            else:
                _, m, cer, ent = steps.phase_b(
                    images, t(wb.labels[rows]), t(table.copy()),
                    t(table[::-1].copy()), t(wb.lengths[rows]),
                    t(ids[rows]), update_crnn=False)
                loss = float(m["loss"])
            out[step] = dict(loss=loss, unet=unet, crnn=crnn, po=po,
                             cer=cer, ent=ent)
        return out

    got = run(slice(RANK * bl, (RANK + 1) * bl), WORLD_GROUP)
    res = dict(same=all(same_on_every_rank(
        g["unet"], g["crnn"], g["po"], *([g["cer"], g["ent"]]
                                         if g["cer"] is not None else []))
        for g in got.values()))
    if RANK == 0:
        ref = run(slice(0, B), None)
        for step in got:
            g, r = got[step], ref[step]
            res[step] = dict(
                loss_rel=rel(g["loss"], r["loss"]),
                unet_params=param_diffs(g["unet"], r["unet"], wd=0.0),
                bn_abs=buffer_diff(g["unet"], r["unet"]))
        g, r = got["phase_b"], ref["phase_b"]
        res.update(cer_abs=float((g["cer"] - r["cer"]).abs().max()),
                   ent_abs=float((g["ent"] - r["ent"]).abs().max()))
    return res


def case_warmup_trainer():
    from qea_ocr_tpu_torch.train.crnn_trainer import (
        CrnnTrainerConfig, TrainCRNN)
    out = os.path.join(OUT, "crnn")
    tr = TrainCRNN(CrnnTrainerConfig(
        device="cpu", dataset="synthetic", ocr="Fake", batch_size=8,
        epochs=2, synthetic_train_size=8, synthetic_val_size=10, std=2,
        lstm_hidden=HIDDEN, data_parallel=True,
        corruption=dict(noise_std=0.03, shading=0.05, salt_pepper=0.0),
        crnn_model_path=os.path.join(out, "model"), log_dir=out))
    tr.train()
    res = dict(calls=tr.ocr.total_calls,
               same=same_on_every_rank(tr.model, tr.optimizer))
    if RANK == 0:
        with open(os.path.join(out, "metrics.jsonl")) as f:
            res["records"] = [json.loads(line) for line in f]
        res["checkpoints"] = sorted(os.listdir(out))
    return res


def case_area_trainer():
    from qea_ocr_tpu_torch.train.area_trainer import (
        AreaTrainerConfig, TrainNNPrepArea)
    out = os.path.join(OUT, "area")
    tr = TrainNNPrepArea(AreaTrainerConfig(
        device="cpu", batch_size=8, epochs=1, ocr="Fake",
        dataset="synthetic", synthetic_train_size=16, synthetic_val_size=8,
        corruption=dict(noise_std=0.08, shading=0.1, salt_pepper=0.0),
        minibatch_subset="rangeCER", minibatch_subset_prop=0.5,
        inner_limit=2, inner_limit_skip=True, window_size=2,
        lstm_hidden=HIDDEN, unet_features=FEATURES, data_parallel=True,
        exp_base_path=out))
    tr.train()
    res = dict(calls=tr.ocr.total_calls,
               same=same_on_every_rank(tr.prep_model, tr.crnn_model,
                                       tr.prep_optimizer, tr.cer_table),
               side=sorted(os.listdir(os.path.join(out, "tracked_labels"))))
    if RANK == 0:
        with open(os.path.join(out, "metrics.jsonl")) as f:
            res["record"] = json.loads(f.readline())
    return res


def case_indivisible():
    from qea_ocr_tpu_torch.train.area_trainer import (
        AreaTrainerConfig, TrainNNPrepArea)
    from qea_ocr_tpu_torch.train.crnn_trainer import (
        CrnnTrainerConfig, TrainCRNN)
    msgs = []
    for make in (lambda: TrainCRNN(CrnnTrainerConfig(
                     device="cpu", dataset="synthetic", batch_size=3,
                     synthetic_train_size=4, synthetic_val_size=2,
                     lstm_hidden=HIDDEN, data_parallel=True)),
                 lambda: TrainNNPrepArea(AreaTrainerConfig(
                     device="cpu", batch_size=3, ocr="Fake",
                     dataset="synthetic", synthetic_train_size=4,
                     synthetic_val_size=2, lstm_hidden=HIDDEN,
                     unet_features=FEATURES, data_parallel=True,
                     exp_base_path=os.path.join(OUT, "indivisible")))):
        try:
            make()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return dict(messages=msgs)


def case_clean_docs():
    from qea_ocr_tpu_torch.cli import clean_docs
    from qea_ocr_tpu_torch.serve.cleaner import DocumentCleaner
    from qea_ocr_tpu_torch.utils.io import save_image_png
    src = os.path.join(OUT, "docs")
    ckpt = os.path.join(OUT, "prep.pt")
    if RANK == 0:
        os.makedirs(src, exist_ok=True)
        rng = np.random.default_rng(9)
        for i in range(5):
            h, w = (80 + 4 * i, 100 + 6 * i)
            save_image_png(rng.random((h, w)).astype(np.float32),
                           os.path.join(src, f"doc_{i}.png"))
        torch.save(models()[0].state_dict(), ckpt)
        DocumentCleaner(ckpt, device="cpu", batch_size=3, doc_size=DOC,
                        unet_features=FEATURES).clean_dir(
            src, os.path.join(OUT, "clean_sp"))
    dist.barrier()
    clean_docs.main(["--prep_path", ckpt, "--input_dir", src,
                     "--output_dir", os.path.join(OUT, "clean_dp"),
                     "--batch_size", "3", "--doc_size", *map(str, DOC),
                     "--unet_features", str(FEATURES), "--device", "cpu",
                     "--data_parallel"])
    cleaner = DocumentCleaner(ckpt, device="cpu", batch_size=3,
                              doc_size=DOC, unet_features=FEATURES,
                              data_parallel=True)
    arrays = [np.random.default_rng(10 + i).random((90, 120)).astype(
        np.float32) for i in range(5)]
    dp_arrays = cleaner.clean_arrays_uint8(arrays)
    dist.barrier()
    res = dict(batch_size=cleaner.batch_size)
    if RANK == 0:
        sp_arrays = DocumentCleaner(
            ckpt, device="cpu", batch_size=3, doc_size=DOC,
            unet_features=FEATURES).clean_arrays_uint8(arrays)

        def files(d):
            d = os.path.join(OUT, d)
            return {n: open(os.path.join(d, n), "rb").read()
                    for n in sorted(os.listdir(d))}
        sp, dp = files("clean_sp"), files("clean_dp")
        res.update(names_sp=sorted(sp), names_dp=sorted(dp),
                   bytes_equal=sp == dp,
                   arrays_equal=len(sp_arrays) == len(dp_arrays) and all(
                       np.array_equal(a, b)
                       for a, b in zip(sp_arrays, dp_arrays)))
    return res


# ------------------------------------------------------------ patch trainer
TRAIN_DOCS, VAL_DOCS, STRIPS, PROP, INNER = 8, 3, 3, 0.5, 2


def patch_trainer(out, **kw):
    from qea_ocr_tpu_torch.train.patch_trainer import (
        PatchTrainerConfig, TrainNNPrep)
    tr = TrainNNPrep(PatchTrainerConfig(
        device="cpu", epochs=1, ocr="Fake", dataset="synthetic",
        synthetic_train_docs=TRAIN_DOCS, synthetic_val_docs=VAL_DOCS,
        synthetic_strips_per_doc=STRIPS, max_strips=4,
        batch_docs=TRAIN_DOCS, doc_size=DOC,
        corruption=dict(noise_std=0.08, shading=0.1, salt_pepper=0.0),
        minibatch_subset="rangeCER", minibatch_subset_prop=PROP,
        inner_limit=INNER, inner_limit_skip=True, window_size=2,
        weightgen_method="decaying", lstm_hidden=HIDDEN,
        unet_features=FEATURES, exp_base_path=out, **kw))
    best = tr.train()
    # the ranks of a model group hold different shards: compare the tables
    state = (tr.cer_table, tr.ent_table) if kw.get("tensor_parallel") else (
        tr.prep_model, tr.crnn_model, tr.prep_optimizer, tr.crnn_optimizer,
        tr.cer_table, tr.ent_table)
    res = dict(calls=tr.ocr.total_calls, pc=tr._pc, pi=tr._pi, dl=tr._dl,
               best=list(best), subset=[int(i) for i in
                                        tr._local_train_indices],
               same=same_on_every_rank(*state),
               side=sorted(os.listdir(os.path.join(out, "tracked_labels"))))
    if RANK == 0:
        with open(os.path.join(out, "metrics.jsonl")) as f:
            res["record"] = json.loads(f.readline())
        res["ckpts"] = sorted(os.listdir(os.path.join(out, "ckpts")))
    return tr, res


def case_patch_trainer_dp():
    return patch_trainer(os.path.join(OUT, "dp"), data_parallel=True)[1]


def case_patch_trainer_tp():
    from torch.distributed.tensor import DTensor

    from qea_ocr_tpu_torch.models.crnn import CRNN
    from qea_ocr_tpu_torch.models.unet import UNet
    from qea_ocr_tpu_torch.utils.io import load_checkpoint
    out = os.path.join(OUT, "tp")
    tr, res = patch_trainer(out, tensor_parallel=2)
    res["dtensors"] = sum(isinstance(p, DTensor)
                          for p in tr.prep_model.parameters())
    res["twin_shares"] = tr.prep_model.shares_state(tr.prep_eval_model)
    if RANK == 0:
        ck = os.path.join(out, "ckpts")
        prep = [n for n in res["ckpts"] if n.startswith("Prep_model_0_")
                and not n.endswith(".optim")][0]
        unet = UNet(init_features=FEATURES, conv_impl="xla")
        crnn = CRNN(charmap().vocab_size, lstm_hidden=HIDDEN)
        load_checkpoint(os.path.join(ck, prep), unet)
        load_checkpoint(os.path.join(ck, "CRNN_model_0"), crnn)
        x = torch.rand(1, 1, *DOC, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            res["plain_forward_finite"] = bool(torch.isfinite(
                unet.eval()(x)).all() and torch.isfinite(
                crnn.eval()(x[..., :32, :128])).all())
    return res


# ------------------------------------------------------- the 2x2 mesh case
def case_tp_step():
    from torch.distributed.tensor import DTensor, Shard

    from qea_ocr_tpu_torch.parallel.tp import make_mesh_2d, tp_spec
    mesh = make_mesh_2d(2, 2)
    b = patch_batch()
    D = b["batch"].strip_mask.shape[0]
    d = mesh.get_local_rank("data")
    dl = D // 2
    got = run_patch_step(b, slice(d * dl, (d + 1) * dl),
                         mesh.get_group("data"), *models(), tp_mesh=mesh)
    placements = {}
    for name, p in got["crnn"].named_parameters():
        want = tp_spec(p, 2)
        placements[name] = [
            list(p.shape), isinstance(want, Shard),
            isinstance(p, DTensor) and p.placements[1] == Shard(p.ndim - 1)]
    unet_whole, crnn_whole = whole_params(got["unet"]), whole_params(got["crnn"])
    whole = [torch.from_numpy(v) for w in (unet_whole, crnn_whole)
             for _, v in sorted(w.items())]
    res = dict(placements=placements,
               same=same_on_every_rank(got["cer"], got["ent"], *whole))
    if RANK == 0:
        ref = run_patch_step(b, slice(0, D), None, *models())
        res.update(
            loss_b_rel=rel(got["loss_b"], ref["loss_b"]),
            loss_a_rel=rel(got["loss_a"], ref["loss_a"]),
            unet_params=param_diffs(unet_whole, ref["unet"]),
            crnn_params=param_diffs(crnn_whole, ref["crnn"]),
            cer_abs=float((got["cer"] - ref["cer"]).abs().max()),
            ent_abs=float((got["ent"] - ref["ent"]).abs().max()))
    return res


MODES = dict(
    dp=(case_patch_step, case_warmup_step, case_area_steps,
        case_warmup_trainer, case_area_trainer, case_indivisible,
        case_clean_docs),
    mh=(case_patch_trainer_dp, case_patch_trainer_tp),
    tp4=(case_tp_step,))


def main():
    global WORLD_GROUP
    assert maybe_init_distributed("cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == WORLD
    WORLD_GROUP = dist.group.WORLD
    results = {}
    for case in MODES[MODE]:
        name = case.__name__[len("case_"):]
        try:
            results[name] = case()
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        dist.barrier()
    with open(os.path.join(OUT, f"{MODE}_{RANK}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
