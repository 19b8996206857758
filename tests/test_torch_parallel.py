"""Data parallelism of the port (spegnet_tpu_torch/parallel, the trainer's
DDP step, the sharded evaluator and predictor) against the JAX package's
``data`` axis, on the CPU with 2 gloo ranks that torch.multiprocessing
spawns (a file store under tmp_path; tests/torch_parallel_workers.py).

* ``create_mesh`` / ``mesh_from_config``: JAX's sizes on the conftest's 8
  virtual CPU devices, and JAX's ValueError where JAX raises; the port also
  refuses a data axis that leaves processes out and an axis above 1 that
  the model does not name as its spatial axis by name, and accepts
  ``model.spatial_axis`` (tests/test_torch_spatial.py), a ``model`` axis
  beside ``data`` (tests/test_torch_tensor_parallel.py) and both
  (tests/test_torch_sp_model.py);
* ``pad_batch`` equals the JAX trainer's ``_pad_batch`` field by field with
  the same weights, and ``shard_batch`` gives each rank the rows
  ``P("data")`` places on its device;
* one Trainer step over 2 ranks, at global batch 4 and at the tail batch 3
  (padded to 4, the pad weighted 0), in f64, against JAX's step on a
  {"data": 2} mesh (the gradient of its loss with the sample weights, then
  the update half of its train step): the loss, every gradient, the BN
  running statistics and the updated parameters, to the tolerances of
  tests/test_torch_train.py (parameters: PARAM_ATOL); the same step on one
  rank (the padded batch with its weights at batch 3) equal within f64
  rounding, and the two ranks equal to each other bit for bit;
* the train, validation and evaluation loaders with ``shard`` (rank, 2): each
  rank's batches are its rows of the whole batches, padded as the trainer
  pads them (train, validation) or to the batch size (evaluation), on the
  whole batch's canvas;
* the evaluator over 2 ranks against 1 rank: the same means and per-sample
  metrics, and the same files; ``python -m spegnet_tpu_torch predict`` under
  ``torch.distributed.run`` with 2 CPU ranks against one process: the same
  PNGs, byte for byte, and the same summary count."""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
import yaml
from PIL import Image

from spegnet_tpu import losses as jl
from spegnet_tpu.data.pipeline import TrainBatch as JaxTrainBatch
from spegnet_tpu.engine import trainer as jtrainer
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.parallel import mesh as jmesh
from spegnet_tpu.parallel.sharding import shard_batch as jax_shard_batch
from spegnet_tpu_torch.data.dataset import concat_train_datasets, get_test_datasets
from spegnet_tpu_torch.data.pipeline import (
    ImageProcessor,
    TrainBatch,
    ValBatch,
    eval_loader,
    train_loader,
    val_loader,
)
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.parallel import mesh as tmesh
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax

from test_torch_train import (  # noqa: E402  (same directory)
    GRAD_L2_RTOL,
    GRAD_TENSOR_RTOL,
    _batch,
    _jax_in_f64,
    _port_model,
    train_config,
    write_dataset,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
# Updated parameters after one AdamW step in f64: an element's update is
# lr * g / (|g| + eps), whose slope is lr / eps where |g| << eps, so
# gradients equal to 1e-8 of their tensor's max move it by up to ~1e-12.
PARAM_ATOL = 1e-10


# -- the mesh ------------------------------------------------------------------

MESH_CASES = [
    ({"data": -1}, 8), ({"data": 8}, 8), ({"data": 16}, 8), ({"data": -1, "model": -1}, 8),
    ({"data": 3, "model": -1}, 8), ({"data": -1}, 1), ({"data": 2}, 1), ({"data": 1}, 1),
]


@pytest.mark.parametrize("spec,n", MESH_CASES)
def test_create_mesh_matches_jax(spec, n):
    try:
        want = dict(jmesh.create_mesh(spec, jax.devices()[:n]).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0][:20]):
            tmesh.create_mesh(spec, n)
        return
    assert all(v > 0 for v in want.values())
    got = tmesh.create_mesh(spec, n)
    assert got.shape == want and got.data == n and got.rank == 0


@pytest.mark.parametrize("spec,n,error,match", [
    ({"data": 4}, 8, ValueError, "world has 8 processes"),
    ({"data": 2, "model": 2, "sp": 2}, 8, NotImplementedError, "'sp' = 2: no part of the port"),
    ({"data": -1, "model": 2, "sp": 2}, 4, NotImplementedError, "the spatial axis model.spatial_"),
])
def test_create_mesh_refuses_what_is_not_ported(spec, n, error, match):
    """JAX builds these meshes (a sub-mesh of the devices, a model axis
    beside a second axis above 1 that the model does not name as its
    spatial axis); the port refuses them by name."""
    assert dict(jmesh.create_mesh(spec, jax.devices()[:n]).shape)
    with pytest.raises(error, match=match):
        tmesh.create_mesh(spec, n)


@pytest.mark.parametrize("spec,n", [({"data": 2, "model": 2, "sp": 2}, 8),
                                    ({"data": -1, "model": 2, "sp": 2}, 4)])
def test_create_mesh_accepts_a_named_spatial_axis_beside_model(spec, n):
    """The same meshes with ``model.spatial_axis: sp`` (the layout and groups:
    tests/test_torch_sp_model.py)."""
    got = tmesh.create_mesh(spec, n, "sp")
    assert got.shape == dict(jmesh.create_mesh(spec, jax.devices()[:n]).shape)
    assert (got.sp, got.model, got.data) == (2, 2, n // 4)


def test_mesh_from_config_and_spatial_axis():
    assert tmesh.mesh_from_config(None, 3).shape == {"data": 3}
    assert tmesh.mesh_from_config({"mesh": {"data": 2}}, 2).data == 2
    assert tmesh.mesh_from_config({}).shape == {"data": 1}   # no torchrun: one process
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.mesh_from_config({"mesh": {"data": 2}})
    # model.spatial_axis is carried and its axis accepted beside data
    # (sequence parallelism, tests/test_torch_spatial.py)
    cfg = SPEGNetConfig.from_dict({"encoder": {"variant": "test"}, "spatial_axis": "sp"})
    assert cfg.spatial_axis == "sp"
    mesh = tmesh.mesh_from_config({"mesh": {"data": 1, "sp": 2}}, 2, cfg.spatial_axis)
    assert mesh.shape == {"data": 1, "sp": 2} and (mesh.data, mesh.sp) == (1, 2)


# -- padding and sharding --------------------------------------------------------

def _host_batch(rng, b):
    masks = (rng.random((b, 8, 12)) > 0.5).astype(np.uint8)
    return dict(images=rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8), masks=masks,
                edges=masks[:, ::-1].copy(), mask_hw=rng.integers(4, 9, (b, 2), dtype=np.int32),
                edge_hw=rng.integers(4, 9, (b, 2), dtype=np.int32))


@pytest.mark.parametrize("b,n", [(3, 2), (4, 2), (5, 4), (1, 4), (7, 2)])
def test_pad_batch_matches_jax(rng, b, n):
    fields = _host_batch(rng, b)
    want, want_w = jtrainer.Trainer._pad_batch(types.SimpleNamespace(data_axis=n),
                                               JaxTrainBatch(**fields))
    got, got_w = sharding.pad_batch(TrainBatch(**fields), n)
    np.testing.assert_array_equal(got_w, want_w)
    for f in dataclasses.fields(JaxTrainBatch):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    assert got.sample_w is None
    vb, vw = sharding.pad_batch(ValBatch(**fields, dst=fields["masks"] * 0.5,
                                         nearest_idx=fields["masks"].astype(np.int32)), n)
    np.testing.assert_array_equal(vw, want_w)
    np.testing.assert_array_equal(vb.dst, np.concatenate(
        [fields["masks"] * 0.5, np.repeat(fields["masks"][:1] * 0.5, len(vw) - b, 0)]))


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_rows_are_the_data_axis_split(rng, n):
    """Rank r's rows are those JAX's batch_sharding puts on device r."""
    fields = _host_batch(rng, 8)
    mesh = jmesh.create_mesh({"data": n}, jax.devices()[:n])
    placed = jax_shard_batch(fields["images"], mesh)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, dev in enumerate(mesh.devices.reshape(-1)):
        got = sharding.shard_batch(TrainBatch(**fields), r, n)
        np.testing.assert_array_equal(got.images, by_device[dev])
        np.testing.assert_array_equal(got.mask_hw, fields["mask_hw"][sharding.rows_of(r, n, 8)])


@pytest.mark.parametrize("kind", ["train", "val", "eval"])
def test_sharded_loaders_split_the_whole_batches(eval_workspace, tmp_path, kind):
    """5 samples in batches of 2 (train, validation: a tail of 1, padded
    with row 0 at weight 0) or 4 (evaluation: zero-padded to 4)."""
    proc = ImageProcessor(64)
    if kind == "eval":
        ds = get_test_datasets([str(eval_workspace[1])])["SYNTH"]

        def load(shard):
            return list(eval_loader(ds, proc, 4, (64, 128), num_workers=0, shard=shard))
    else:
        ds = concat_train_datasets([str(write_dataset(
            tmp_path / "ds", ((70, 90), (64, 64), (80, 50), (60, 72), (90, 66))))])

        def load(shard):
            if kind == "val":
                return list(val_loader(ds, proc, 2, (64, 128), num_workers=0, shard=shard))
            return list(train_loader(ds, proc, 2, (64, 128), seed=3, num_workers=0,
                                     shard=shard))
    whole = load((0, 1))
    ranks = [load((r, 2)) for r in range(2)]
    assert len(whole) == len(ranks[0]) == len(ranks[1]) == (2 if kind == "eval" else 3)
    for k, batch in enumerate(whole):
        assert batch.images.shape[0] == (4 if kind == "eval" else min(2, 5 - 2 * k))
        if kind != "eval":
            batch, w = sharding.pad_batch(batch, 2)
            batch.sample_w = w
        for r in range(2):
            want, got = sharding.shard_batch(batch, r, 2), ranks[r][k]
            for f in dataclasses.fields(want):
                a, b = getattr(got, f.name), getattr(want, f.name)
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=f"{k} {r} {f.name}")
                elif f.name != "originals":
                    assert a == b, (k, r, f.name)


# -- the DDP step ------------------------------------------------------------------

def _ragged_batch(rng, b):
    """A {"test", 64^2} batch of b samples (f64 normalized images)."""
    parts = [_batch(rng) for _ in range(-(-b // 2))]
    canvas = max(p.masks.shape[1] for p in parts), max(p.masks.shape[2] for p in parts)

    def cat(name, pad=False):
        arrs = [getattr(p, name) for p in parts]
        if pad:
            arrs = [np.pad(a, ((0, 0), (0, canvas[0] - a.shape[1]), (0, canvas[1] - a.shape[2])))
                    for a in arrs]
        return np.concatenate(arrs)[:b]

    images = cat("images").astype(np.float64) / 255.0
    images = (images - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])
    return TrainBatch(images, cat("masks", True), cat("edges", True), cat("mask_hw"),
                      cat("edge_hw"))


@pytest.fixture(scope="module")
def ddp_case(tmp_path_factory, jax_variables):
    """The job (the batches of 4 and 3 samples, the f64 weights), JAX's
    step on each, and the 2-rank port's step on each (the ranks run while
    JAX compiles)."""
    root = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(3)
    full = _ragged_batch(rng, 4)
    tail = dataclasses.replace(full, **{f.name: getattr(full, f.name)[:3]
                                        for f in dataclasses.fields(full) if f.name != "sample_w"})
    _, variables = jax_variables
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    state = _port_model(variables, compute_dtype="float64").state_dict()
    job = {"state": state, "batches": [full, tail],
           "config": train_config([], batch_size=4)}
    torch.save(job, root / "job.pt")
    ranks = workers.spawn(workers.train_rank, 2, root, join=False)
    jax_out = _jax_steps(job, variables)
    while not ranks.join():
        pass
    return job, jax_out, [torch.load(root / f"train_rank{r}.pt", weights_only=False)
                          for r in range(2)]


@pytest.fixture(scope="module")
def jax_variables():
    rng = np.random.default_rng(5)
    model = JaxSPEGNet(JaxConfig(variant="test"))
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    return model, variables


def _jax_steps(job, variables, spec=None):
    """JAX's step on a {"data": 2} mesh (or the mesh of ``spec``, whose
    ``model`` axis shards the parameters as the JAX trainer places them)
    for each batch: (loss, gradients and new running statistics, updated
    parameters and running statistics), under port names."""
    from spegnet_tpu.parallel.sharding import param_shardings

    mp = pytest.MonkeyPatch()
    spec = spec or {"data": 2}
    mesh = jmesh.create_mesh(spec, jax.devices()[:int(np.prod(list(spec.values())))])
    cfg = train_config([])
    jt = jtrainer.Trainer.__new__(jtrainer.Trainer)   # its optimizer, without a model init
    jt.config, jt.grad_clip = cfg["training"], 1.0
    jt.params = variables["params"]
    jt.scheduler = jtrainer.PlateauScheduler({g: 1.0 for g in jtrainer._GROUPS}, 0.7, 5, 1e-6)
    out = []
    with _jax_in_f64(mp):
        params = jax.device_put(variables["params"], param_shardings(variables["params"], mesh))
        _optimizer(jt)
        jmodel = JaxSPEGNet(JaxConfig(variant="test", compute_dtype="float64"))

        def loss_fn(p, bs, images, masks, edges, mask_hw, edge_hw, w):
            o, mut = jmodel.apply({"params": p, "batch_stats": bs}, images, train=True,
                                  mutable=["batch_stats"])
            ld = jl.cod_loss(o["predictions"], o["edge"], masks, edges, mask_hw, edge_hw,
                             jl.LossConfig(), w)
            return ld["loss"], mut["batch_stats"]

        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

        @jax.jit
        def update(grads, params):
            # the update half of the JAX trainer's train_step
            updates, _ = jt.tx.update(grads, jt.tx.init(params), params)
            updates = jax.tree_util.tree_map(lambda u, lr, g: u * (-lr) * jt._scales_array()[g],
                                             updates, jt.lr_tree, jt.group_idx_tree)
            return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

        for batch in job["batches"]:
            padded, w = jtrainer.Trainer._pad_batch(types.SimpleNamespace(data_axis=spec["data"]),
                                                    JaxTrainBatch(**{
                                                        f.name: getattr(batch, f.name)
                                                        for f in dataclasses.fields(JaxTrainBatch)}))
            dev = jax_shard_batch((padded.images, padded.masks.astype(np.float64),
                                   padded.edges.astype(np.float64), padded.mask_hw,
                                   padded.edge_hw, w.astype(np.float64)), mesh)
            with jax.set_mesh(mesh):
                (loss, new_bs), grads = grad(params, variables["batch_stats"], *dev)
                new_params = update(grads, params)
            loss, grads, new_bs, new_params = jax.device_get((loss, grads, new_bs, new_params))
            out.append((float(loss), state_dict_from_jax({"params": grads, "batch_stats": new_bs}),
                        state_dict_from_jax({"params": new_params, "batch_stats": new_bs})))
    mp.undo()
    return out


def _optimizer(jt):
    """The JAX trainer's optax chain, label and lr trees for ``jt.params``
    (its ``_init_state`` without the model init and the device placement)."""
    import optax

    opt = jt.config["optimizer"]
    base_lr, wd, ratio = opt["learning_rate"], opt["weight_decay"], opt["encoder_lr_ratio"]
    labels = jax.tree_util.tree_map_with_path(lambda p, _: jtrainer._param_label(p), jt.params)
    jt.lr_tree = jax.tree_util.tree_map(
        lambda lbl: base_lr * (ratio if lbl == "encoder" else 1.0), labels)
    jt.group_idx_tree = jax.tree_util.tree_map(lambda lbl: jtrainer._GROUPS.index(lbl), labels)
    wd_map = {"encoder": 0.0, "decoder": wd, "decoder_norm": 0.0}
    inner = optax.multi_transform(
        {g: optax.chain(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                        optax.add_decayed_weights(wd_map[g])) for g in jtrainer._GROUPS}, labels)
    jt.tx = optax.chain(optax.clip_by_global_norm(jt.grad_clip), inner)


def _hold_grads(got, want, names):
    gmax = max(np.abs(want[n]).max() for n in names)
    diff2 = ref2 = 0.0
    for n in names:
        g, w = got[n].numpy(), want[n]
        diff2 += float(((g - w) ** 2).sum())
        ref2 += float((w ** 2).sum())
        if np.abs(w).max() <= 1e-12 * gmax:
            assert np.abs(g).max() <= 1e-12 * gmax, n
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TENSOR_RTOL * np.abs(w).max(),
                                   err_msg=n)
    assert np.sqrt(diff2 / ref2) <= GRAD_L2_RTOL


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_ddp_step_matches_jax_data_axis(ddp_case, which):
    _, jax_steps, ranks = ddp_case
    loss, want_grads, want_after = jax_steps[which]
    got = ranks[0][which]
    assert got["rows"] == (4, 3)[which]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-12)
    _hold_grads(got["grads"], want_grads, list(got["grads"]))
    for n, b in got["stats"].items():
        np.testing.assert_allclose(b.numpy(), want_after[n], rtol=1e-10, atol=1e-14, err_msg=n)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want_after[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_two_ranks_equal_one_rank(ddp_case, which):
    """Both ranks hold the same result bit for bit; one rank on the same
    global batch (at batch 3 the padded batch with its weights: the global
    program) gives it within f64 rounding."""
    job, _, ranks = ddp_case
    a, b = ranks[0][which], ranks[1][which]
    for key in ("grads", "params", "stats"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    assert a["metrics"] == b["metrics"]
    batch = job["batches"][which]
    if which == 1:
        batch, w = sharding.pad_batch(batch, 2)
        batch.sample_w = w
    one = workers.train_step_result(job, batch, 1)
    assert one["rows"] == a["rows"]
    np.testing.assert_allclose(a["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-13)
    _hold_grads(a["grads"], {n: g.numpy() for n, g in one["grads"].items()}, list(a["grads"]))
    for n in a["params"]:
        np.testing.assert_allclose(a["params"][n].numpy(), one["params"][n].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    for n in a["stats"]:
        np.testing.assert_allclose(a["stats"][n].numpy(), one["stats"][n].numpy(), rtol=1e-12,
                                   atol=1e-15, err_msg=n)


# -- evaluate and predict over 2 ranks ----------------------------------------------

MODEL = {"encoder": {"variant": "test"}, "compute_dtype": "float32",
         "image_processing": {"target_size": 64}}
SIZES = [(48, 56), (64, 48), (56, 64), (40, 40), (70, 66)]


@pytest.fixture(scope="module")
def eval_workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    ds = root / "SYNTH"
    for d in ("Imgs", "GT"):
        (ds / "test" / d).mkdir(parents=True)
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy - h / 2) ** 2 + (xx - w / 2.5) ** 2) < (min(h, w) / 3.5) ** 2
        img[m] = (img[m] * 0.6 + 80).astype(np.uint8)
        Image.fromarray(img).save(ds / "test" / "Imgs" / f"s{i}.png")
        Image.fromarray((m * 255).astype(np.uint8)).save(ds / "test" / "GT" / f"s{i}.png")
    model = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(2))
    ckpt = root / "model.pth"
    torch.save({"model_state_dict": model.state_dict(), "config": {"model": MODEL}}, ckpt)
    return root, ds, ckpt


def _tree(run_root: Path):
    return {str(p.relative_to(run_root)): p.read_bytes() for p in sorted(run_root.rglob("*"))
            if p.is_file() and p.suffix in (".png", ".json") and "summary" not in p.name}


def test_evaluate_two_ranks_equal_one_rank(eval_workspace, tmp_path):
    """Batch 2 over 2 ranks against batch 1 on one: one image per forward
    on both sides."""
    root, ds, ckpt = eval_workspace
    out = {}
    for world in (1, 2):
        job = {"base": str(tmp_path / f"w{world}"), "stamp": "run", "ckpt": str(ckpt),
               "model": MODEL, "batch": world, "dataset": str(ds)}
        work = tmp_path / f"job{world}"
        work.mkdir()
        torch.save(job, work / "job.pt")
        workers.spawn(workers.evaluate_rank, world, work)
        res = [torch.load(work / f"evaluate_rank{r}.pt", weights_only=False)
               for r in range(world)]
        for r in res[1:]:
            assert r["means"] == res[0]["means"] and r["samples"] == res[0]["samples"]
        out[world] = res[0], tmp_path / f"w{world}" / "evaluation" / "runs" / "run_run"
    (one, one_dir), (two, two_dir) = out[1], out[2]
    assert list(two["samples"]) == [f"s{i}" for i in range(len(SIZES))]
    for name, m in one["samples"].items():
        for k, v in m.items():
            assert abs(two["samples"][name][k] - v) <= 1e-6, (name, k)
    for k, v in one["means"].items():
        assert abs(two["means"][k] - v) <= 1e-6, k
    summary = json.loads((two_dir / "SYNTH" / "evaluation_summary.json").read_text())
    assert summary["timing"]["total_samples"] == len(SIZES)
    assert summary["categories"] == one["summary"]["categories"]
    assert sorted(_tree(two_dir)) == sorted(_tree(one_dir))


def test_cli_predict_two_ranks_equal_one_process(eval_workspace, tmp_path):
    """Batch 2 over 2 ranks against batch 1 in one process: one image per
    forward on both sides."""
    root, ds, ckpt = eval_workspace
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    runs = {}
    for world in (1, 2):
        cwd = tmp_path / f"p{world}"
        cwd.mkdir()
        cfg = cwd / "cfg.yaml"
        cfg.write_text(yaml.safe_dump({"model": MODEL, "prediction": {"batch_size": world},
                                       "training": {}, "parallel": {"mesh": {"data": -1}}}))
        args = ["-m", "spegnet_tpu_torch", "predict", "--model", str(ckpt), "--input",
                str(ds / "test" / "Imgs"), "--config", str(cfg), "--device", "cpu"]
        launch = ([sys.executable] if world == 1 else
                  [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc_per_node={world}"])
        proc = subprocess.run(launch + args, cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        run = list((cwd / "results" / "prediction" / "runs").glob("run_*"))
        assert len(run) == 1, run
        runs[world] = run[0]
    one, two = _tree(runs[1]), _tree(runs[2])
    assert len(one) == 6 * len(SIZES) and one.keys() == two.keys()
    assert all(one[k] == two[k] for k in one), [k for k in one if one[k] != two[k]]
    summary = json.loads((runs[2] / "prediction_summary.json").read_text())
    assert summary["total_predictions"] == len(SIZES)
