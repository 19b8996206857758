"""The spatial axis and the ``model`` axis in one mesh (``parallel.mesh:
{data: D, sp: S, model: M}`` with ``model.spatial_axis: sp``) against the
JAX package on that mesh and against one process, on the CPU with gloo
ranks that torch.multiprocessing spawns (tests/torch_parallel_workers.py,
which import no JAX):

* the layout: rank r where JAX puts device r, its data / spatial / model
  index, and its spatial, model, data and replica groups (the ranks of one
  model index) as the lines of JAX's device array, for four specs, the
  groups of two of them as the spawned ranks made them;
* the bf16 SPEGNet (Hiera-tiny, 64^2, batch 2) on 4 ranks {1, 2, 2}, its
  tokens split over the spatial groups and its matmuls over the model
  groups, against JAX's on the same mesh (its parameters placed by
  ``param_shardings``, Pallas interpreted): each output within
  tests/test_torch_bf16.py's MEAN_REL / MAX_REL, each rank's T-block and
  front at the local shapes JAX's kernels received, the head on the band of
  the rank's spatial index (the same on both ranks of a model group), there
  and in every step below;
* one f64 Trainer step on ``SP_VARIANT`` down the token route
  (``torch_parallel_workers.open_morton``) at {1, 2, 2} (global batch 4,
  its tail of 3, and both again with ``training.remat``) and {2, 2, 2}
  (batch 4, 8 ranks) against the one-process f64 step: the loss, every
  gradient, the BN running statistics and the updated parameters, within
  tests/test_torch_parallel.py's tolerances; the replicated parameters
  bit-equal on every rank, each shard bit-equal across its spatial group;
* JAX's own f64 step on {1, 2, 2} (its ``model`` axis; its ``sp`` axis
  splits nothing in f64) as an oracle for the ``test`` SPEGNet's step on 4
  ranks: the loss, the statistics and every gradient but the four that
  JAX's model axis gets wrong (tests/test_torch_tensor_parallel.py
  JAX_MODEL_AXIS_FAULT);
* checkpoints both ways between {1, 2, 2} and one process;
* the Evaluator (f32 down the token route) and ``python -m
  spegnet_tpu_torch predict`` under ``torch.distributed.run`` at {1, 2, 2}
  against one process: per-sample metrics within 1e-5, the same files."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
import yaml
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.parallel import mesh as jmesh
from spegnet_tpu.parallel.sharding import param_shardings
from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.parallel import mesh as tmesh
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax, to_torch

from test_torch_bf16 import MAX_REL, MEAN_REL, _rel  # noqa: E402  (same directory)
from test_torch_geometry import _perturb  # noqa: E402
from test_torch_parallel import (  # noqa: E402,F401  (eval_workspace, jax_variables: fixtures)
    MODEL,
    PARAM_ATOL,
    _hold_grads,
    _jax_steps,
    _ragged_batch,
    _tree,
    eval_workspace,
    jax_variables,
)
from test_torch_spatial import _jax_calls, _open_jax_gates, assert_head_bands  # noqa: E402
from test_torch_tensor_parallel import JAX_MODEL_AXIS_FAULT  # noqa: E402
from test_torch_train import _port_model, train_config  # noqa: E402

torch.set_num_threads(1)
MESH = {"data": 1, "sp": 2, "model": 2}
MESH8 = {"data": 2, "sp": 2, "model": 2}
GROUP_AXES = {"sp_group": ("sp",), "model_group": ("model",), "data_group": ("data",),
              "replica_group": ("data", "sp")}


def _size(spec):
    return int(np.prod(list(spec.values())))


# -- (a) the layout ---------------------------------------------------------------------

def _lines(want, shape, axes, at):
    """The ranks of JAX's device array ``want`` that share every index of
    position ``at`` but those of ``axes``, in row-major order."""
    names = list(shape)
    idx = tuple(slice(None) if names[i] in axes else c for i, c in enumerate(at))
    return want[idx].reshape(-1).tolist()


@pytest.mark.parametrize("spec,n", [(MESH, 4), (MESH8, 8), ({"model": 2, "sp": 2, "data": -1}, 8),
                                    ({"sp": 2, "data": 1, "model": 2}, 4)])
def test_layout_matches_jax(spec, n):
    """Rank r sits where JAX puts device r; its indices and the ranks of
    each of its groups are the lines of that array (the replica group: the
    ranks of its model index)."""
    jm = jmesh.create_mesh(spec, jax.devices()[:n])
    want = np.vectorize(lambda d: d.id)(jm.devices)
    got = tmesh.create_mesh(spec, n, "sp")
    assert got.shape == dict(jm.shape) and (got.sp, got.model) == (2, 2)
    np.testing.assert_array_equal(tmesh.layout(got.shape), want)
    names = list(got.shape)
    groups = {g: tmesh.axis_groups(got.shape, tuple(a for a in names if a in axes))
              for g, axes in GROUP_AXES.items()}
    for r in range(n):
        m = dataclasses.replace(got, rank=r)
        at = tuple(int(i) for i in np.argwhere(want == r)[0])
        idx = dict(zip(names, at))
        assert (m.data_index, m.sp_index, m.model_index) == (idx["data"], idx["sp"],
                                                            idx["model"])
        assert m.token_shard == (None, idx["sp"], 2) and m.model_shard == (None, idx["model"], 2)
        assert m.lead == (idx["sp"] == 0 and idx["model"] == 0)
        for g, axes in GROUP_AXES.items():
            assert [line for line in groups[g] if r in line] == [
                _lines(want, got.shape, axes, at)], (g, r)


# -- the ranks' runs --------------------------------------------------------------------

def _pad(batch, n):
    padded, w = sharding.pad_batch(batch, n)
    padded.sample_w = w
    return padded


def jax_oracle(root: str) -> None:
    """JAX's f64 step on {1, 2, 2} of root/oracle_in.pt's job and weights,
    in a process of its own, into root/oracle_out.pt (or the error it
    raised, recorded in place of the oracle)."""
    import importlib
    import pathlib
    import pkgutil

    import spegnet_tpu

    # every module of the JAX package loaded first, as in the test process,
    # so that _jax_in_f64 reaches the ones the step imports lazily
    for mod in pkgutil.walk_packages(spegnet_tpu.__path__, "spegnet_tpu."):
        try:
            importlib.import_module(mod.name)
        except ImportError:
            pass
    root = pathlib.Path(root)
    job, variables = torch.load(root / "oracle_in.pt", weights_only=False)
    try:
        out = {"step": _jax_steps(job, variables, MESH)[0], "error": None}
    except Exception as e:
        out = {"step": None, "error": f"{type(e).__name__}: {e}"}
    torch.save(out, root / "oracle_out.pt")


@pytest.fixture(scope="module")
def case(tmp_path_factory, jax_variables, eval_workspace):
    """The jobs, the ranks' results ({1, 2, 2}: the bf16 forward, the steps
    with and without remat, the oracle steps, the checkpoints, the
    Evaluator; {2, 2, 2}: the steps), JAX's bf16 forward (here) and f64 step
    (in a process of its own) on {1, 2, 2}, computed while the ranks run,
    and the one-process references."""
    import multiprocessing

    root = tmp_path_factory.mktemp("sp_model")
    # (d) the oracle: the ``test`` SPEGNet on JAX's weights (f64), batch 4
    _, variables = jax_variables
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    oracle = {"state": _port_model(variables, compute_dtype="float64").state_dict(),
              "batches": [_ragged_batch(np.random.default_rng(3), 4)],
              "config": train_config([], batch_size=4)}
    torch.save((oracle, variables), root / "oracle_in.pt")
    jax_proc = multiprocessing.get_context("spawn").Process(target=jax_oracle, args=(str(root),))
    jax_proc.start()
    # (b) the bf16 forward: JAX's Hiera-tiny SPEGNet, perturbed
    rng = np.random.default_rng(0)
    fwd_vars = _perturb(jax.device_get(jax.jit(JaxSPEGNet(JaxConfig(
        variant="tiny", compute_dtype="bfloat16")).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))), rng)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    forward = {"state": to_torch(state_dict_from_jax(fwd_vars)), "x": torch.from_numpy(x),
               "mesh": MESH, "variant": "tiny", "dtype": "bfloat16"}
    # (c) the f64 steps on SP_VARIANT
    variant = workers.register_sp_variant()
    model = init_weights(SPEGNet(SPEGNetConfig(variant=variant)),
                         torch.Generator().manual_seed(1)).double()
    b4 = synthetic_train_batch(4, np.random.default_rng(3), 64, gt_range=(48, 64))
    b3 = dataclasses.replace(b4, **{f.name: getattr(b4, f.name)[:3]
                                    for f in dataclasses.fields(b4) if f.name != "sample_w"})
    config = {"model": {"encoder": {"variant": variant}, "compute_dtype": "float64",
                        "image_processing": {"target_size": 64}},
              "training": {"batch_size": 4, "num_epochs": 1, "num_workers": 0, "val_ratio": 0,
                           "gradient_clip": 1.0, "canvas_buckets": [64, 128],
                           "optimizer": {"learning_rate": 1e-3, "weight_decay": 1e-5,
                                         "encoder_lr_ratio": 0.05}}}
    sp_job = {"state": model.state_dict(), "batches": [b4, b3], "config": config,
              "variant": variant}
    # (e) the one-process checkpoint the ranks resume from: after a step on b4
    tr = workers.make_trainer(sp_job, tmesh.create_mesh({"data": 1}, 1))
    workers.step_result(tr, b4)
    torch.save(tr.checkpoint_state(0, {}), root / "one_ckpt.pth")
    one_resumed = workers.step_result(tr, b3)
    # (f) the Evaluator (f32 down the token route)
    _, ds, ckpt = eval_workspace
    ev = {"base": str(root / "eval"), "stamp": "run", "ckpt": str(ckpt),
          "model": {**MODEL, "spatial_axis": "sp"}, "batch": 2, "dataset": str(ds),
          "mesh": MESH}
    jobs = {"d1": {**sp_job, "mesh": MESH, "forward": forward, "oracle": oracle, "eval": ev,
                   "tasks": ["forward", "steps", "remat_steps", "oracle_steps", "checkpoint",
                             "evaluate"]},
            "d2": {**sp_job, "batches": [b4], "mesh": MESH8, "tasks": ["steps"]}}
    ctx = {}
    for key, job in jobs.items():
        (root / key).mkdir()
        torch.save(job, root / key / "job.pt")
        (root / key / "one_ckpt.pth").write_bytes((root / "one_ckpt.pth").read_bytes())
        ctx[key] = workers.spawn(workers.sp_model_rank, _size(job["mesh"]), root / key,
                                 join=False)
    # JAX's bf16 forward on {1, 2, 2}, its kernel calls recorded
    mp = pytest.MonkeyPatch()
    calls = _open_jax_gates(mp)
    try:
        mesh = jmesh.create_mesh(MESH, jax.devices()[:4])
        jmodel = JaxSPEGNet(JaxConfig(variant="tiny", compute_dtype="bfloat16",
                                      spatial_axis="sp"))
        with jax.set_mesh(mesh):
            xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
            vs = {"params": jax.device_put(fwd_vars["params"],
                                           param_shardings(fwd_vars["params"], mesh)),
                  "batch_stats": jax.device_put(fwd_vars["batch_stats"],
                                                NamedSharding(mesh, P()))}
            want = jax.device_get(jax.jit(jmodel.apply)(vs, xs))
    finally:
        mp.undo()
    one = {("d1", 0): workers.train_step_result(sp_job, b4, 1),
           ("d1", 1): workers.train_step_result(sp_job, b3, 1),
           ("d2", 0): workers.train_step_result(sp_job, _pad(b4, 2), 1)}
    ranks = {}
    for key, c in ctx.items():
        while not c.join():
            pass
        ranks[key] = [torch.load(root / key / f"sp_model_rank{r}.pt", weights_only=False)
                      for r in range(_size(jobs[key]["mesh"]))]
    jax_proc.join()
    assert jax_proc.exitcode == 0, f"the JAX step's process exited with {jax_proc.exitcode}"
    jax_step = torch.load(root / "oracle_out.pt", weights_only=False)
    return {"root": root, "jobs": jobs, "ranks": ranks, "one": one, "resumed": one_resumed,
            "forward": (want, list(calls)), "jax_step": jax_step["step"],
            "jax_error": jax_step["error"], "eval_job": ev}


@pytest.mark.parametrize("key", ["d1", "d2"])
def test_ranks_made_jax_groups(case, key):
    """The sub-groups each spawned rank made are the lines of JAX's device
    array."""
    spec = case["jobs"][key]["mesh"]
    n = _size(spec)
    want = np.vectorize(lambda d: d.id)(jmesh.create_mesh(spec, jax.devices()[:n]).devices)
    for r, res in enumerate(case["ranks"][key]):
        rec = res["mesh"]
        at = tuple(int(i) for i in np.argwhere(want == r)[0])
        assert (rec["data_index"], rec["sp_index"], rec["model_index"]) == at
        for g, axes in GROUP_AXES.items():
            assert rec["groups"][g] == _lines(want, spec, axes, at), (g, r)


# -- (b) the bf16 forward ---------------------------------------------------------------

def test_tiny_calls_at_jax_local_shapes(case):
    """JAX's kernels saw the plan's sharded calls at local shapes on
    {1, 2, 2}; each port rank called its wrappers at the same shapes,
    token-major, on both model indices."""
    _, jax_calls = case["forward"]
    cfg = thiera.HIERA_VARIANTS["tiny"]
    plan = thiera.trunk_plan(cfg, 16, torch.bfloat16, False, sp=2)
    assert jax_calls == _jax_calls(plan, thiera.block_specs(cfg), 2, 16, 2)
    assert ("fwd", (2, 96, 128)) in jax_calls and ("qpool", (2, 96, 128)) in jax_calls
    want, h = [], 16
    for (route, sharded), spec in zip(plan, thiera.block_specs(cfg)):
        if sharded:
            want.append((route, (2, h * h // 2, spec.dim)))
        if spec.q_pool:
            h //= 2
    for r in case["ranks"]["d1"]:
        assert r["forward"]["calls"] == want


@pytest.mark.parametrize("output", ["prediction 0", "prediction 1", "prediction 2", "edge",
                                    "context", "fused", "edge_features"])
def test_bf16_forward_on_4_ranks_matches_jax(case, output):
    """Every rank's outputs equal (the mesh has one data index) and within
    the bf16 tolerance of JAX's forward on the same mesh."""
    want, _ = case["forward"]

    def pick(out):
        if output.startswith("prediction"):
            return out["predictions"][int(output[-1])]
        return out["edge"] if output == "edge" else out["features"][output]

    ranks = [pick(r["forward"]["out"]) for r in case["ranks"]["d1"]]
    for t in ranks[1:]:
        assert torch.equal(t, ranks[0]), "the ranks of a data index differ"
    mean_rel, max_rel = _rel(ranks[0], pick(want))
    assert mean_rel <= MEAN_REL and max_rel <= MAX_REL, (mean_rel, max_rel)


def test_head_runs_on_bands(case):
    """The bf16 forward at 64^2 on {1, 2, 2}: both ranks of a model group
    ran the same band of the head (their spatial index's), with its halos."""
    ranks = case["ranks"]["d1"]
    assert [r["forward"]["sp_index"] for r in ranks] == [0, 0, 1, 1]
    for r in ranks:
        assert_head_bands(r["forward"]["head_rows"], 64, 2)
        assert r["forward"]["head_rows"] == ranks[0]["forward"]["head_rows"]


# -- (c) the f64 step -------------------------------------------------------------------

def _np(d):
    return {n: t.numpy() for n, t in d.items()}


def _hold_step(got, one, tol_loss=1e-12):
    np.testing.assert_allclose(got["metrics"]["loss"], one["metrics"]["loss"], rtol=tol_loss)
    _hold_grads(got["grads"], _np(one["grads"]), list(one["grads"]))
    for n in one["params"]:
        np.testing.assert_allclose(got["params"][n].numpy(), one["params"][n].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    for n in one["stats"]:
        np.testing.assert_allclose(got["stats"][n].numpy(), one["stats"][n].numpy(),
                                   rtol=1e-10, atol=1e-14, err_msg=n)


def _hold_replicas(ranks, steps, which):
    """Replicated parameters bit-equal on every rank; each shard bit-equal
    on the ranks of its model index (its spatial group and data group)."""
    first = {}
    for r in ranks:
        local, m = r[steps][which]["local"], r["mesh"]["model_index"]
        for n, p in local.items():
            key = (n, m if sharding.shard_dim(n) is not None else None)
            if key in first:
                assert torch.equal(p, first[key]), key
            else:
                first[key] = p
        assert r[steps][which]["metrics"] == ranks[0][steps][which]["metrics"]


STEP_CASES = [("d1", "steps", 0), ("d1", "steps", 1), ("d1", "remat_steps", 0),
              ("d1", "remat_steps", 1), ("d2", "steps", 0)]


@pytest.mark.parametrize("key,steps,which", STEP_CASES,
                         ids=["122-batch4", "122-tail3", "122-remat-batch4", "122-remat-tail3",
                              "222-batch4"])
def test_step_equals_one_process(case, key, steps, which):
    ranks = case["ranks"][key]
    got, one = ranks[0][steps][which], case["one"][key, which]
    b_loc = (4, 3)[which] if key == "d1" else 2
    assert got["rows"] == one["rows"] == (4, 3)[which]
    want = [("fused_block_t", (b_loc, 128, 16)), ("qpool_front", (b_loc, 128, 16)),
            ("global_ref", (b_loc, 8, 64))]
    # under remat the global block runs again in the backward's recompute
    assert got["calls"] == want + want[-1:] * (steps == "remat_steps")
    _hold_step(got, one)
    _hold_replicas(ranks, steps, which)


@pytest.mark.parametrize("key,steps,which", STEP_CASES + [("d1", "oracle_steps", 0)],
                         ids=["122-batch4", "122-tail3", "122-remat-batch4", "122-remat-tail3",
                              "222-batch4", "122-oracle"])
def test_step_runs_the_head_on_bands(case, key, steps, which):
    """Each rank's head ran on its band of rows in the train step (the step
    itself: test_step_equals_one_process, test_jax_step_oracle)."""
    for r in case["ranks"][key]:
        assert_head_bands(r[steps][which]["head_rows"], 64, 2)


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_remat_step_equals_the_step(case, which):
    """The recompute runs the forward's collectives again in order: the
    same step, bit for bit."""
    for r in case["ranks"]["d1"]:
        a, b = r["remat_steps"][which], r["steps"][which]
        assert a["metrics"] == b["metrics"]
        for key in ("grads", "params", "stats"):
            for n in b[key]:
                assert torch.equal(a[key][n], b[key][n]), (key, n)


# -- (d) JAX's step as the oracle -------------------------------------------------------

def test_jax_step_oracle(case):
    """The ``test`` SPEGNet's f64 step on 4 ranks {1, 2, 2} against JAX's on
    the same mesh, every gradient but JAX_MODEL_AXIS_FAULT's."""
    assert case["jax_error"] is None, case["jax_error"]
    loss, grads, after = case["jax_step"]
    got = case["ranks"]["d1"][0]["oracle_steps"][0]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-12)
    ok = [n for n in got["grads"] if n not in JAX_MODEL_AXIS_FAULT]
    _hold_grads(got["grads"], grads, ok)
    for n, b in got["stats"].items():
        np.testing.assert_allclose(b.numpy(), after[n], rtol=1e-10, atol=1e-14, err_msg=n)
    _hold_replicas(case["ranks"]["d1"], "oracle_steps", 0)


# -- (e) checkpoints --------------------------------------------------------------------

def test_checkpoint_round_trips(case):
    """{1, 2, 2} -> one process: the checkpoint holds the full reference
    schema and one process resumed from it takes the ranks' next step; one
    process -> {1, 2, 2}: the ranks resumed from one process's checkpoint
    take its next step."""
    root, job = case["root"], case["jobs"]["d1"]
    ckpt = torch.load(root / "d1" / "sp_model_ckpt.pth", weights_only=False)
    one = torch.load(root / "one_ckpt.pth", weights_only=False)
    assert ckpt.keys() == one.keys()
    for n, t in one["model_state_dict"].items():
        assert ckpt["model_state_dict"][n].shape == t.shape, n
        np.testing.assert_allclose(ckpt["model_state_dict"][n].numpy(), t.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    st, st_one = ckpt["optimizer_state_dict"]["state"], one["optimizer_state_dict"]["state"]
    assert st.keys() == st_one.keys()
    assert all(st[i][k].shape == s[k].shape for i, s in st_one.items()
               for k in ("exp_avg", "exp_avg_sq"))
    tr = workers.make_trainer(job, tmesh.create_mesh({"data": 1}, 1))
    tr.load_checkpoint(root / "d1" / "sp_model_ckpt.pth", resume=True)
    resumed = workers.step_result(tr, job["batches"][1])
    rank0 = case["ranks"]["d1"][0]
    _hold_step(resumed, rank0["after_ckpt"], tol_loss=1e-13)
    _hold_step(rank0["from_one"], case["resumed"], tol_loss=1e-13)


# -- (f) the engines --------------------------------------------------------------------

def test_evaluate_equals_one_process(case):
    ev = case["eval_job"]
    one = workers.evaluate_result({**ev, "base": ev["base"] + "_one", "mesh": {"data": 1},
                                   "model": MODEL}, 1)
    for r in case["ranks"]["d1"]:
        got = r["evaluate"]
        assert list(got["samples"]) == list(one["samples"])
        for name, m in one["samples"].items():
            for k, v in m.items():
                assert abs(got["samples"][name][k] - v) <= 1e-5, (name, k)
    runs = [workers.Path(ev["base"] + s) / "evaluation" / "runs" / "run_run"
            for s in ("", "_one")]
    assert sorted(_tree(runs[0])) == sorted(_tree(runs[1]))


def test_cli_predict_equals_one_process(eval_workspace, tmp_path):
    """``python -m spegnet_tpu_torch predict`` under torch.distributed.run
    with 4 CPU ranks, ``model.spatial_axis: sp`` and ``parallel.mesh: {data:
    1, sp: 2, model: 2}``, against one process without the axes: the same
    PNGs, byte for byte (the checkpoint's f32 config runs every block
    whole)."""
    _, ds, ckpt = eval_workspace
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(workers.Path(__file__).resolve().parents[1]),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for world, mesh in ((1, {"data": -1}), (4, MESH)):   # both at once
        cwd = tmp_path / f"p{world}"
        cwd.mkdir()
        model = {**MODEL, "spatial_axis": "sp"} if world == 4 else MODEL
        cfg = cwd / "cfg.yaml"
        cfg.write_text(yaml.safe_dump({"model": model, "prediction": {"batch_size": 2},
                                       "training": {}, "parallel": {"mesh": mesh}}))
        args = ["-m", "spegnet_tpu_torch", "predict", "--model", str(ckpt), "--input",
                str(ds / "test" / "Imgs"), "--config", str(cfg), "--device", "cpu"]
        launch = ([sys.executable] if world == 1 else
                  [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc_per_node={world}"])
        procs[world] = cwd, subprocess.Popen(launch + args, cwd=cwd, env=env, text=True,
                                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    runs = {}
    for world, (cwd, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        run = list((cwd / "results" / "prediction" / "runs").glob("run_*"))
        assert len(run) == 1, run
        runs[world] = run[0]
    one, four = _tree(runs[1]), _tree(runs[4])
    assert len(one) == 30 and one.keys() == four.keys()
    assert all(one[k] == four[k] for k in one), [k for k in one if one[k] != four[k]]
