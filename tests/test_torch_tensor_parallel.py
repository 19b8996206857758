"""The model (tensor-parallel) axis of the port (``parallel.mesh: {data: D,
model: M}``) against the JAX package's ``model`` axis, on the CPU with gloo
ranks that torch.multiprocessing spawns (tests/torch_parallel_workers.py,
which import no JAX):

* the mesh: ranks laid out as JAX lays out its devices, each rank's data and
  model index and its model and data groups, on the conftest's 8 virtual
  CPU devices;
* the partition: ``param_spec`` leaf for leaf against JAX's
  ``param_shardings`` on a {"data": 4, "model": 2} mesh (the ``test``
  SPEGNet, every parameter and statistic), ``join_shards`` of every rank's
  ``shard_param`` the identity (qkv's shards whole heads), and the model
  report's parameters per rank;
* one f64 Trainer step over 4 ranks {"data": 2, "model": 2} at global batch
  4 and at the tail batch 3, against JAX's step on a {"data": 2, "model":
  2} mesh (its parameters placed by ``param_shardings``): the loss, every
  gradient gathered and the BN statistics, to tests/test_torch_train.py's
  tolerances.  JAX's own step on that mesh is wrong for four gradients
  (:data:`JAX_MODEL_AXIS_FAULT`, held apart against JAX's {"data": 2}
  step), so the port's are held against JAX's {"data": 2} step there, and
  the updated parameters, which the faulty gradients move through the
  global-norm clip, against JAX's {"data": 2} update; that step and the one over 2
  ranks {"data": 1, "model": 2} against one process within f64 rounding,
  every rank's parameters bit-equal (the replicated ones within each model
  group, and every one across the data axis); the same on the Morton
  trunk's kernel routes (T-blocks and fronts on gathered weights, the
  fronts' tails Megatron-style), opened to f64;
* the trunk of a small Hiera at 384^2 whose decomposed blocks take the lanes
  attention, on H / M heads per rank, against one process: outputs and
  every gradient;
* checkpoints: a TP checkpoint is the full reference schema (parameters
  and AdamW moments) and resumes in one process, and a one-process
  checkpoint resumes under the model axis, each next step equal to the
  other side's within f64 rounding;
* the Evaluator and ``python -m spegnet_tpu_torch predict`` under
  ``torch.distributed.run`` at {"data": 1, "model": 2} against one process:
  the same metrics and byte-equal PNGs."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
import yaml

from spegnet_tpu.parallel import mesh as jmesh
from spegnet_tpu.parallel.sharding import param_shardings
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.parallel import mesh as tmesh
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.utils.model_info import params_per_rank
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax

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
from test_torch_train import _port_model, train_config  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TP_MESH = {"data": 2, "model": 2}
MODEL_ONLY = {"data": 1, "model": 2}
# The JAX package's step on a {"data": 2, "model": 2} mesh of the conftest's
# virtual CPU devices gives the e-ASPP branches' depthwise dilated convs
# (spegnet_tpu/models/cfi.py ConvBNReLU, feature_group_count = channels)
# weight gradients twice (dilation 1, 6) or none (12, 18) of its own
# {"data": 2} step's, which the port's one-process step matches: a fault of
# the reference under its model axis (test_jax_model_axis_fault_is_confined).
JAX_MODEL_AXIS_FAULT = tuple(f"context.branches.{i}.0.weight" for i in range(4))


# -- the mesh ------------------------------------------------------------------------

@pytest.mark.parametrize("spec,n,spatial", [
    ({"data": 4, "model": 2}, 8, None), ({"data": -1, "model": 2}, 4, None),
    ({"data": 2, "model": 2}, 4, "sp"), ({"model": 2, "data": 4}, 8, None)])
def test_model_axis_layout_matches_jax(spec, n, spatial):
    """Rank r sits where JAX puts device r; its data / model index and its
    model and data groups are the lines of that array (a spatial axis the
    mesh does not have is S = 1)."""
    jm = jmesh.create_mesh(spec, jax.devices()[:n])
    want = np.vectorize(lambda d: d.id)(jm.devices)
    got = tmesh.create_mesh(spec, n, spatial)
    assert got.shape == dict(jm.shape) and got.sp == 1 and got.model == jm.shape["model"]
    np.testing.assert_array_equal(tmesh.layout(got.shape), want)
    axes = list(got.shape)
    d_ax, m_ax = axes.index("data"), axes.index("model")
    groups = {a: tmesh.axis_groups(got.shape, a) for a in ("data", "model")}
    for r in range(n):
        m = dataclasses.replace(got, rank=r)
        at = tuple(int(i) for i in np.argwhere(want == r)[0])
        assert (m.data_index, m.model_index) == (at[d_ax], at[m_ax])
        assert m.model_shard == (None, at[m_ax], got.model) and m.token_shard is None
        assert m.lead == (at[m_ax] == 0)
        for a, ax in (("model", m_ax), ("data", d_ax)):
            line = want[tuple(slice(None) if i == ax else c for i, c in enumerate(at))].tolist()
            assert [g for g in groups[a] if r in g] == [line], (a, r)


def test_model_axis_needs_a_group():
    mesh = tmesh.create_mesh(MODEL_ONLY, 2)
    with pytest.raises(RuntimeError, match="model axis of 2 needs a torch.distributed"):
        tmesh.require_group(mesh)


# -- the partition ---------------------------------------------------------------------

def test_param_spec_matches_jax(jax_variables):
    """Every state-dict entry of the ``test`` SPEGNet: the dims JAX's
    param_shardings splits on a {"data": 4, "model": 2} mesh, carried to the
    port's names and layouts by state_dict_from_jax, are those param_spec
    names, and a shard has JAX's shard shape."""
    _, variables = jax_variables
    mesh = jmesh.create_mesh({"data": 4, "model": 2}, jax.devices()[:8])
    specs = param_shardings(variables["params"], mesh)
    shard = jax.tree_util.tree_map(lambda a, s: np.zeros(s.shard_shape(a.shape), np.float32),
                                   variables["params"], specs)
    full = state_dict_from_jax(variables)
    want = state_dict_from_jax({"params": shard, "batch_stats": variables["batch_stats"]})
    sd = SPEGNet(SPEGNetConfig(variant="test")).state_dict()
    assert sorted(sd) == sorted(full)
    split = 0
    for name, t in sd.items():
        jax_spec = tuple("model" if a != b else None
                         for a, b in zip(full[name].shape, want[name].shape))
        jax_spec = jax_spec if "model" in jax_spec else ()
        assert sharding.param_spec(name) == jax_spec, name
        assert tuple(sharding.shard_param(name, t, 1, 2).shape) == want[name].shape, name
        split += bool(jax_spec)
    assert split == 6 * 4   # qkv w / b, proj w, fc1 w / b, fc2 w of the 4 blocks


@pytest.mark.parametrize("m", [2, 4])
def test_join_of_shards_is_identity(m):
    model = init_weights(SPEGNet(SPEGNetConfig(variant="test")), torch.Generator().manual_seed(4))
    for name, t in model.state_dict().items():
        parts = [sharding.shard_param(name, t, i, m) for i in range(m)]
        assert torch.equal(sharding.join_shards(name, parts), t), name
        if name.endswith("attn.qkv.weight"):
            c = t.shape[0] // 3
            for i, p in enumerate(parts):   # rank i: q, k and v of its heads
                want = torch.cat([t[j * c + i * c // m: j * c + (i + 1) * c // m]
                                  for j in range(3)])
                assert torch.equal(p, want), name


def test_params_per_rank():
    sd = SPEGNet(SPEGNetConfig(variant="test")).state_dict()
    params = dict(SPEGNet(SPEGNetConfig(variant="test")).named_parameters())
    want = sum(t.numel() // (2 if sharding.shard_dim(n) is not None else 1)
               for n, t in sd.items() if n in params)
    assert params_per_rank({"encoder": {"variant": "test"}}, 2) == want
    assert params_per_rank({"encoder": {"variant": "test"}}, 1) == sum(
        p.numel() for p in params.values())


# -- the step -------------------------------------------------------------------------

def _pad(batch, n):
    padded, w = sharding.pad_batch(batch, n)
    padded.sample_w = w
    return padded


def _one(job, batches, morton=False):
    """One process's step on each batch (with ``morton``, on the Morton
    trunk's routes opened to f64)."""
    keep = workers.thiera.takes_morton
    if morton:
        workers.open_morton_any_dtype()
    try:
        return [workers.train_step_result(job, b, 1) for b in batches]
    finally:
        workers.thiera.takes_morton = keep


@pytest.fixture(scope="module")
def tp_case(tmp_path_factory, jax_variables, eval_workspace):
    """The jobs, the ranks' results ({"data": 2, "model": 2}: the steps;
    {"data": 1, "model": 2}: the steps, the Morton steps, the checkpoints,
    the 384^2 trunk, the Evaluator), JAX's step on {"data": 2, "model": 2}
    (the ranks run while JAX compiles) and the one-process references."""
    root = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(3)
    full = _ragged_batch(rng, 4)
    tail = dataclasses.replace(full, **{f.name: getattr(full, f.name)[:3]
                                        for f in dataclasses.fields(full) if f.name != "sample_w"})
    _, variables = jax_variables
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    state = _port_model(variables, compute_dtype="float64").state_dict()
    base = {"state": state, "batches": [full, tail], "config": train_config([], batch_size=4)}
    # the trunk at 384^2: a small Hiera whose decomposed blocks take the lanes
    # attention (torch_parallel_workers.LANES_VARIANT)
    lanes = workers.register_lanes_variant()
    trunk = init_weights(SPEGNet(SPEGNetConfig(variant=lanes)), torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(7)
    x = torch.randn((1, 384, 384, 3), generator=g, dtype=torch.float64)
    cot = [torch.randn((1, 384 // 2 ** (i + 2), 384 // 2 ** (i + 2), c), generator=g,
                       dtype=torch.float64)
           for i, c in enumerate(workers.LANES_VARIANT.channels)]
    _, ds, ckpt = eval_workspace
    ev = {"base": str(root / "eval_tp"), "stamp": "run", "ckpt": str(ckpt), "model": MODEL,
          "batch": 1, "dataset": str(ds), "mesh": MODEL_ONLY}
    jobs = {"tp4": {**base, "mesh": TP_MESH, "tasks": ["steps"]},
            "tp2": {**base, "mesh": MODEL_ONLY, "eval": ev,
                    "trunk_state": trunk.double().state_dict(), "trunk_x": x, "trunk_cot": cot,
                    "tasks": ["steps", "checkpoint", "trunk", "evaluate", "morton_steps"]}}
    # the one-process checkpoint the ranks resume from: after a step on batch 0
    tr = workers.make_trainer(base, tmesh.create_mesh({"data": 1}, 1))
    workers.step_result(tr, full)
    torch.save(tr.checkpoint_state(0, {}), root / "one_ckpt.pth")
    one_resumed = workers.step_result(tr, tail)
    ctx = {}
    for key, job in jobs.items():
        (root / key).mkdir()
        torch.save(job, root / key / "job.pt")
        if key == "tp2":
            (root / key / "one_ckpt.pth").write_bytes((root / "one_ckpt.pth").read_bytes())
        world = int(np.prod(list(job["mesh"].values())))
        ctx[key] = (world, workers.spawn(workers.tp_rank, world, root / key, join=False))
    jax_out = {"tp": _jax_steps(base, variables, TP_MESH),
               "dp": _jax_steps(base, variables, {"data": 2})}
    ranks = {}
    for key, (world, c) in ctx.items():
        while not c.join():
            pass
        ranks[key] = [torch.load(root / key / f"tp_rank{r}.pt", weights_only=False)
                      for r in range(world)]
    one = {"steps": _one(base, [full, tail]), "padded": _one(base, [_pad(tail, 2)])[0],
           "morton": _one(base, [full, tail], morton=True), "resumed": one_resumed,
           "trunk": workers.trunk_result(jobs["tp2"])}
    return {"root": root, "jobs": jobs, "base": base, "ranks": ranks, "jax": jax_out,
            "one": one, "eval_job": ev}


# train_config's largest learning rate and AdamW's eps
LR, EPS = 1e-3, 1e-8


def _hold_params(got, want, got_grads, want_grads):
    """The updated parameters within PARAM_ATOL plus what the gradients'
    own difference moves them by: AdamW's first step is lr c g / (c |g| +
    eps) for the clip factor c, whose slope lr c eps / (c |g| + eps)^2 grows
    to lr / eps = 1e5 where a gradient cancels to near zero, and there turns
    f64 rounding of the gradient into ~1e-10 of the parameter."""
    norm = np.sqrt(sum(float((np.asarray(g) ** 2).sum()) for n, g in want_grads.items()
                       if n in got))
    c = 1.0 / max(1.0, norm)
    for n, p in got.items():
        g1, g2 = got_grads[n].numpy(), np.asarray(want_grads[n])
        slope = LR * c * EPS / (c * np.minimum(np.abs(g1), np.abs(g2)) + EPS) ** 2
        tol = PARAM_ATOL + slope * np.abs(g1 - g2)
        diff = np.abs(p.numpy() - want[n])
        assert (diff <= tol).all(), (n, float(diff.max()), float((diff - tol).max()))


def _hold_step(got, want_loss, want_grads, want_params, want_stats, tol_loss=1e-12,
               param_grads=None):
    """``param_grads``: the gradients that gave ``want_params`` (default
    ``want_grads``)."""
    np.testing.assert_allclose(got["metrics"]["loss"], want_loss, rtol=tol_loss)
    _hold_grads(got["grads"], want_grads, list(got["grads"]))
    for n, b in got["stats"].items():
        np.testing.assert_allclose(b.numpy(), want_stats[n], rtol=1e-10, atol=1e-14, err_msg=n)
    _hold_params(got["params"], want_params, got["grads"],
                 want_grads if param_grads is None else param_grads)


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_tp_step_matches_jax_model_axis(tp_case, which):
    """{"data": 2, "model": 2} against JAX's step on the same mesh (where
    that step is right: module docstring)."""
    loss, grads, after = tp_case["jax"]["tp"][which]
    _, dp_grads, dp_after = tp_case["jax"]["dp"][which]
    grads = {**grads, **{n: dp_grads[n] for n in JAX_MODEL_AXIS_FAULT}}
    got = tp_case["ranks"]["tp4"][0]["steps"][which]
    assert got["rows"] == (4, 3)[which]
    _hold_step(got, loss, grads, dp_after, after, param_grads=dp_grads)


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_jax_model_axis_fault_is_confined(tp_case, which):
    """JAX's {"data": 2, "model": 2} step against its own {"data": 2} step:
    the same loss and statistics, every gradient equal but the four of
    JAX_MODEL_AXIS_FAULT, which differ by their whole size."""
    loss, grads, after = tp_case["jax"]["tp"][which]
    dp_loss, dp_grads, dp_after = tp_case["jax"]["dp"][which]
    np.testing.assert_allclose(loss, dp_loss, rtol=1e-12)
    ok = [n for n in dp_grads if n not in JAX_MODEL_AXIS_FAULT and n in grads]
    _hold_grads({n: torch.from_numpy(grads[n]) for n in ok}, dp_grads, ok)
    for n in JAX_MODEL_AXIS_FAULT:
        assert np.abs(grads[n] - dp_grads[n]).max() > 0.5 * np.abs(dp_grads[n]).max(), n
    for n, v in dp_after.items():
        if "running" in n:
            np.testing.assert_allclose(after[n], v, rtol=1e-10, atol=1e-14, err_msg=n)


def _np(d):
    return {n: t.numpy() for n, t in d.items()}


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
@pytest.mark.parametrize("key", ["tp4", "tp2"])
def test_tp_step_equals_one_process(tp_case, key, which):
    """Each mesh against one process on the same global batch (the tail
    padded with its weights under a data axis of 2, as the global program
    sees it) within f64 rounding; every rank holds the same parameters, bit
    for bit, and its model group the same replicated ones."""
    ranks = tp_case["ranks"][key]
    got = ranks[0]["steps"][which]
    one = tp_case["one"]["padded" if key == "tp4" and which == 1 else "steps"]
    one = one if isinstance(one, dict) else one[which]
    _hold_step(got, one["metrics"]["loss"], _np(one["grads"]), _np(one["params"]),
               _np(one["stats"]), tol_loss=1e-13)
    for r in ranks[1:]:
        other = r["steps"][which]
        assert other["metrics"] == got["metrics"]
        for n in got["params"]:
            assert torch.equal(other["params"][n], got["params"][n]), (r["model_index"], n)
            assert torch.equal(other["grads"][n], got["grads"][n]), (r["model_index"], n)


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
def test_tp_morton_routes_equal_one_process(tp_case, which):
    """The Morton trunk's kernel routes (opened to f64): T-blocks and fronts
    on the weights gathered over the model group, the fronts' tails
    Megatron-style, against one process on the same routes."""
    ranks = tp_case["ranks"]["tp2"]
    got, one = ranks[0]["morton_steps"][which], tp_case["one"]["morton"][which]
    _hold_step(got, one["metrics"]["loss"], _np(one["grads"]), _np(one["params"]),
               _np(one["stats"]), tol_loss=1e-13)
    for n in got["params"]:
        assert torch.equal(ranks[1]["morton_steps"][which]["params"][n], got["params"][n]), n


def test_tp_trunk_lanes_on_local_heads(tp_case):
    """The 384^2 trunk: every lanes attention of a rank runs H / 2 heads, at
    the lengths one process runs (H heads); outputs and every gradient
    within f64 rounding of one process."""
    one = tp_case["one"]["trunk"]
    for r in tp_case["ranks"]["tp2"]:
        got = r["trunk"]
        assert len(got["lanes"]) == len(one["lanes"]) == 3
        assert [(n, h // 2) for n, h in one["lanes"]] == got["lanes"]
        for a, b in zip(got["feats"], one["feats"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12 * float(b.abs().max()))
        _hold_grads(got["grads"], _np(one["grads"]), list(one["grads"]))


def test_tp_checkpoint_round_trips(tp_case):
    """TP -> one process: the checkpoint holds the full reference schema
    (every parameter and AdamW moment gathered, equal to one process's after
    the same step) and one process resumed from it takes the TP run's next
    step; one process -> TP: the ranks resumed from one process's checkpoint
    take its next step."""
    root, base = tp_case["root"], tp_case["base"]
    tp = torch.load(root / "tp2" / "tp_ckpt.pth", weights_only=False)
    one = torch.load(root / "one_ckpt.pth", weights_only=False)
    assert tp.keys() == one.keys()
    for n, t in one["model_state_dict"].items():
        np.testing.assert_allclose(tp["model_state_dict"][n].numpy(), t.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    st_tp, st_one = tp["optimizer_state_dict"]["state"], one["optimizer_state_dict"]["state"]
    assert st_tp.keys() == st_one.keys()
    for k in ("exp_avg", "exp_avg_sq"):   # moments of the gradients: held as gradients
        assert all(st_tp[i][k].shape == s[k].shape for i, s in st_one.items())
        _hold_grads({str(i): st_tp[i][k] for i in st_one},
                    {str(i): s[k].numpy() for i, s in st_one.items()}, [str(i) for i in st_one])
    tr = workers.make_trainer(base, tmesh.create_mesh({"data": 1}, 1))
    tr.load_checkpoint(root / "tp2" / "tp_ckpt.pth", resume=True)
    resumed = workers.step_result(tr, base["batches"][1])
    want = tp_case["ranks"]["tp2"][0]["after_ckpt"]
    for a, b in ((resumed, want), (tp_case["ranks"]["tp2"][0]["from_one"],
                                   tp_case["one"]["resumed"])):
        _hold_step(a, b["metrics"]["loss"], _np(b["grads"]), _np(b["params"]), _np(b["stats"]),
                   tol_loss=1e-13)


def test_tp_evaluate_equals_one_process(tp_case):
    ev = tp_case["eval_job"]
    one = workers.evaluate_result({**ev, "base": ev["base"] + "_one", "mesh": {"data": 1}}, 1)
    for r in tp_case["ranks"]["tp2"]:
        got = r["evaluate"]
        assert list(got["samples"]) == list(one["samples"])
        for name, m in one["samples"].items():
            for k, v in m.items():
                assert abs(got["samples"][name][k] - v) <= 1e-6, (name, k)
    runs = [Path(ev["base"] + s) / "evaluation" / "runs" / "run_run" for s in ("", "_one")]
    assert _tree(runs[0]).keys() == _tree(runs[1]).keys()


def test_tp_cli_predict_equals_one_process(eval_workspace, tmp_path):
    """``python -m spegnet_tpu_torch predict`` under torch.distributed.run
    with {"data": 1, "model": 2} against one process: the same PNGs, byte
    for byte."""
    _, ds, ckpt = eval_workspace
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    runs = {}
    for world, mesh in ((1, {"data": -1}), (2, MODEL_ONLY)):
        cwd = tmp_path / f"p{world}"
        cwd.mkdir()
        cfg = cwd / "cfg.yaml"
        cfg.write_text(yaml.safe_dump({"model": MODEL, "prediction": {"batch_size": 2},
                                       "training": {}, "parallel": {"mesh": mesh}}))
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
    assert len(one) == 30 and one.keys() == two.keys()
    assert all(one[k] == two[k] for k in one), [k for k in one if one[k] != two[k]]
