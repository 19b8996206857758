"""Sequence parallelism of the port (``model.spatial_axis``: the Morton
trunk's tokens split over the ranks of a spatial group) against the JAX
package's, on the CPU with gloo ranks that torch.multiprocessing spawns
(tests/torch_parallel_workers.py, which import no JAX):

* the mesh: ranks laid out as JAX lays out its devices, each rank's data
  and spatial index and its two sub-groups, on the conftest's 8 virtual CPU
  devices; what the port refuses, and the spatial and a model axis
  together, which it accepts (tests/test_torch_sp_model.py);
* the routes: ``models/hiera.trunk_plan`` under S against the shapes that
  reach JAX's Pallas T-kernel (``_forward``) and front (``_qpool_forward``)
  on its mesh -- local token counts -- for Hiera-tiny at 64^2 run through
  Pallas interpreted, and for Hiera-L at 512^2 and 1024^2, S 2 and 4, traced
  with ``jax.eval_shape`` (JAX runs identical consecutive T-blocks as one
  scan, so a run of blocks is one call there);
* the bf16 SPEGNet on 4 ranks ({"data": 2, "sp": 2}) against JAX's on the
  same mesh and weights, each output within mean |diff| / mean |JAX| <= 3%
  and max / max <= 8% (tests/test_torch_bf16.py's tolerance), each rank's
  trunk calls those of the plan at its local shapes, and each rank's head
  convolutions on its band of rows with their halos (models/spegnet.py);
* one f64 Trainer step at {"data": 1, "sp": 2} and {"data": 2, "sp": 2},
  global batch 4 and its tail of 3, against the one-process f64 step: the
  loss, every reduced gradient, the BN running statistics and the updated
  parameters (tests/test_torch_parallel.py's tolerances), every rank's
  parameters bit-equal, each rank's head on its band.  The ranks send the
  f64 model down the token route (``torch_parallel_workers.open_morton``)
  on a small trunk whose plan has every kind of block (``SP_VARIANT``): the
  proof of the trainer's gradient rule across both gathers, the head's
  halos, means and row gathers, and the BatchNorm all-reduce;
* the Evaluator over {"data": 1, "sp": 2} (f32, the token route opened the
  same way) against one process: per-sample metrics within 1e-5 and the
  same files."""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from spegnet_tpu.models.hiera import Hiera as JaxHiera
from spegnet_tpu.models.spegnet import SPEGNet as JaxSPEGNet
from spegnet_tpu.models.spegnet import SPEGNetConfig as JaxConfig
from spegnet_tpu.ops import fused_block_t as jfbt
from spegnet_tpu.ops import pallas_attention as jpa
from spegnet_tpu.parallel import mesh as jmesh
from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import pallas_attention as tpa
from spegnet_tpu_torch.parallel import mesh as tmesh
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.utils.weights import init_weights, state_dict_from_jax, to_torch

from test_torch_bf16 import MAX_REL, MEAN_REL, _rel  # noqa: E402  (same directory)
from test_torch_geometry import _perturb  # noqa: E402
from test_torch_parallel import (  # noqa: E402,F401  (eval_workspace: a fixture)
    MODEL,
    PARAM_ATOL,
    _hold_grads,
    _tree,
    eval_workspace,
)

torch.set_num_threads(1)
SP_MESH = {"data": 2, "sp": 2}


# -- (1) the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [({"data": 2, "sp": 2}, 4), ({"data": 1, "sp": 4}, 4),
                                    ({"data": -1, "sp": 2}, 8), ({"sp": 2, "data": 4}, 8)])
def test_mesh_layout_matches_jax(spec, n):
    """Rank r sits where JAX puts device r; its data / spatial index and its
    sub-groups are the lines of that array."""
    jm = jmesh.create_mesh(spec, jax.devices()[:n])
    want = np.vectorize(lambda d: d.id)(jm.devices)
    got = tmesh.create_mesh(spec, n, "sp")
    assert got.shape == dict(jm.shape) and got.spatial_axis == "sp"
    np.testing.assert_array_equal(tmesh.layout(got.shape), want)
    axes = list(got.shape)
    d_ax, s_ax = axes.index("data"), axes.index("sp")
    groups = {a: tmesh.axis_groups(got.shape, a) for a in ("data", "sp")}
    for r in range(n):
        m = dataclasses.replace(got, rank=r)
        at = tuple(int(i) for i in np.argwhere(want == r)[0])
        assert (m.data_index, m.sp_index) == (at[d_ax], at[s_ax])
        assert m.token_shard == (None, at[s_ax], got.shape["sp"])
        for a, ax in (("sp", s_ax), ("data", d_ax)):
            line = want[tuple(slice(None) if i == ax else c for i, c in enumerate(at))].tolist()
            assert [g for g in groups[a] if r in g] == [line], (a, r)


@pytest.mark.parametrize("spec,n,spatial,error,match", [
    ({"data": 1, "sp": 2, "model": 2}, 4, "sp", None, None),
    ({"data": 2, "sp": 2}, 4, None, NotImplementedError, "'sp'"),
    ({"data": 2, "sp": 2}, 8, "sp", ValueError, "world has 8 processes"),
    ({"data": 2}, 2, "data", ValueError, "names the data axis"),
])
def test_mesh_refuses(spec, n, spatial, error, match):
    """A model axis beside the spatial axis is accepted (``error`` None: the
    combined layout, rank = (d S + s) M + m; its groups against JAX's:
    tests/test_torch_sp_model.py); an axis above 1 that the model does not
    name as its spatial axis is used by nothing; a mesh must cover every
    process; the spatial axis cannot be the data axis."""
    if error is None:
        got = tmesh.create_mesh(spec, n, spatial)
        assert (got.data, got.sp, got.model) == (1, 2, 2) and got.spatial_axis == "sp"
        for r in range(n):
            m = dataclasses.replace(got, rank=r)
            assert r == (m.data_index * 2 + m.sp_index) * 2 + m.model_index
            assert m.token_shard.index == m.sp_index and m.model_shard.index == m.model_index
        return
    with pytest.raises(error, match=match):
        tmesh.create_mesh(spec, n, spatial)


def test_spatial_axis_needs_a_group():
    mesh = tmesh.create_mesh({"data": 1, "sp": 2}, 2, "sp")
    assert (mesh.data, mesh.sp) == (1, 2)
    with pytest.raises(RuntimeError, match="spatial axis of 2 needs a torch.distributed"):
        tmesh.require_group(mesh)
    # the config carries the axis; a mesh without it is S = 1
    cfg = SPEGNetConfig.from_dict({"encoder": {"variant": "test"}, "spatial_axis": "sp"})
    assert cfg.spatial_axis == "sp" and tmesh.create_mesh(None, 1, "sp").token_shard is None


# -- (2) the routes ------------------------------------------------------------------

def _jax_calls(plan, specs, b_loc, hw, sp):
    """The (kernel, shape) calls JAX's trunk makes for ``plan``: one
    ``_forward`` per run of identical sharded T-blocks ([B, C, N / S]), one
    ``_qpool_forward`` per sharded front ([B, Cin, N / S])."""
    out, h, prev = [], hw, None
    for (route, sharded), spec in zip(plan, specs):
        n = h * h // sp
        if route == "fused_block_t" and sharded:
            if prev != spec:
                out.append(("fwd", (b_loc, spec.dim, n)))
            prev = spec
        else:
            prev = None
            if route == "qpool_front" and sharded:
                out.append(("qpool", (b_loc, spec.dim, n)))
        if spec.q_pool:
            h //= 2
    return out


def _open_jax_gates(monkeypatch):
    """JAX's gates open (Pallas interpreted) and the shapes that reach its
    T-kernel and front recorded in call order, in the returned list."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    calls = []
    monkeypatch.setattr(jfbt.pl, "pallas_call", interp)
    monkeypatch.setattr(jfbt, "INTERPRET", True)
    monkeypatch.setattr(jpa, "lanes_supported", tpa.lanes_supported)
    for name, tag in (("_forward", "fwd"), ("_qpool_forward", "qpool")):
        fn = getattr(jfbt, name)
        monkeypatch.setattr(jfbt, name, lambda xt, w, _fn=fn, _t=tag, **kw:
                            calls.append((_t, tuple(xt.shape))) or _fn(xt, w, **kw))
    return calls


@pytest.fixture
def jax_recorder(monkeypatch):
    return _open_jax_gates(monkeypatch)


@pytest.mark.parametrize("size", [512, 1024])
@pytest.mark.parametrize("sp", [2, 4])
def test_hiera_l_routes_match_jax(jax_recorder, size, sp):
    """Hiera-L's plan under S against JAX's trunk traced on a {"data": 2,
    "sp": S} mesh at batch 2: every T-block and front of stages 1-3 sharded
    at its local token count, the three global blocks on "global_ref", stage
    4 whole on the gen-1 block."""
    cfg = thiera.HIERA_VARIANTS["large"]
    plan = thiera.trunk_plan(cfg, size // 4, torch.bfloat16, False, sp=sp)
    routes = collections.Counter(r for r, _ in plan)
    assert routes == {"fused_block_t": 39, "global_ref": 3, "qpool_front": 3,
                      "fused_block": 3}, routes
    assert all(s for r, s in plan if r != "fused_block")
    # the int8 token routes are off under the axis; the whole gen-1 blocks
    # take their int8 form where its gate allows, as JAX's NHWC path does
    i8 = thiera.trunk_routes(cfg, size // 4, torch.bfloat16, True, sp=sp)
    assert [r for r, (_, s) in zip(i8, plan) if s] == [r for r, s in plan if s]
    mesh = jmesh.create_mesh({"data": 2, "sp": sp}, jax.devices()[:2 * sp])
    model = JaxHiera(variant="large", dtype=jnp.bfloat16, spatial_axis="sp")
    x = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
    with jax.set_mesh(mesh):
        variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
        jax_recorder.clear()
        jax.eval_shape(model.apply, variables, x)
    assert jax_recorder == _jax_calls(plan, thiera.block_specs(cfg), 1, size // 4, sp)


@pytest.mark.parametrize("size,sp,want", [
    (1024, 1, {"fused_block": 10, "qpool_front": 3, "fused_attention_lanes": 35}),
    (384, 2, None),
])
def test_routes_outside_the_sharded_trunk(size, sp, want):
    """A spatial axis of size 1 takes no Morton order and no T-block (JAX's
    ``use_z`` / ``can_t``); on a grid that is not 2^k every block runs whole
    on one process's routes."""
    cfg = thiera.HIERA_VARIANTS["large"]
    plan = thiera.trunk_plan(cfg, size // 4, torch.bfloat16, False, sp=sp)
    assert not any(s for _, s in plan)
    routes = [r for r, _ in plan]
    if want is None:
        assert routes == thiera.trunk_routes(cfg, size // 4, torch.bfloat16, False)
    else:
        assert collections.Counter(r for r in routes if r != "plain") == want


# -- (2), (3) Hiera-tiny's routes and the bf16 SPEGNet on 4 ranks ------------------

@pytest.fixture(scope="module")
def sp_forward_case(tmp_path_factory):
    """JAX's bf16 SPEGNet (Hiera-tiny, the spatial axis "sp") on a {"data": 2,
    "sp": 2} mesh at 64^2 batch 4, Pallas interpreted, with the shapes that
    reached its kernels; and the port's on 4 gloo ranks (run while JAX
    computes)."""
    rng = np.random.default_rng(0)
    kw = dict(variant="tiny", compute_dtype="bfloat16")
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = _perturb(jax.device_get(jax.jit(JaxSPEGNet(JaxConfig(**kw)).init)(
        jax.random.PRNGKey(0), x0)), rng)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    calls = _open_jax_gates(mp)
    try:
        root = tmp_path_factory.mktemp("sp_forward")
        torch.save({"state": to_torch(state_dict_from_jax(variables)), "x": torch.from_numpy(x),
                    "mesh": SP_MESH, "variant": "tiny", "dtype": "bfloat16"}, root / "job.pt")
        ranks = workers.spawn(workers.sp_forward_rank, 4, root, join=False)
        mesh = jmesh.create_mesh(SP_MESH, jax.devices()[:4])
        model = JaxSPEGNet(JaxConfig(**kw, spatial_axis="sp"))
        with jax.set_mesh(mesh):
            xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
            vs = jax.device_put(variables, NamedSharding(mesh, P()))
            want = jax.device_get(jax.jit(model.apply)(vs, xs))
        while not ranks.join():
            pass
        got = [torch.load(root / f"sp_forward_rank{r}.pt", weights_only=False)
               for r in range(4)]
        yield want, list(calls), got
    finally:
        mp.undo()


def test_tiny_routes_match_jax(sp_forward_case):
    """Hiera-tiny at 64^2 (patch grid 16), S = 2: block 0's T-block and
    block 1's front sharded, then stage 2's windows (16 local tokens) leave
    the shards; the global blocks take them again, the others run whole.
    JAX's kernels saw exactly the plan's sharded calls at local shapes; each
    port rank called its wrappers at the same shapes, token-major."""
    _, jax_calls, ranks = sp_forward_case
    cfg = thiera.HIERA_VARIANTS["tiny"]
    plan = thiera.trunk_plan(cfg, 16, torch.bfloat16, False, sp=2)
    assert [r for r, s in plan if s] == ["fused_block_t", "qpool_front"] + ["global_ref"] * 3
    assert jax_calls == _jax_calls(plan, thiera.block_specs(cfg), 2, 16, 2)
    want, h = [], 16
    for (route, sharded), spec in zip(plan, thiera.block_specs(cfg)):
        if sharded:
            want.append((route, (2, h * h // 2, spec.dim)))
        if spec.q_pool:
            h //= 2
    for r in ranks:
        assert r["calls"] == want


# The head's convolutions that run as modules (models/cfi.py, models/ped.py;
# the fusion's per-stage 1x1 projection does not): e-ASPP's reduce, four
# branches, global branch, fusion and expand; EFE's two; each decoder block's
# two and its logit head.
HEAD_CONVS = 8 + 2 + 3 * 3


def assert_head_bands(rows, size: int, sp: int) -> None:
    """A rank's head convolutions (torch_parallel_workers.record_head_rows)
    each ran once on its band with its halo: h / S rows of a map of h rows
    at its resolution (H/8; decoder block i and its head at 2^(i + 1) times
    that) and its row padding more on each side, in and out (the band's
    rows are cut from the output); e-ASPP's global branch on the whole 1x1
    map."""
    n8 = thiera.head_bands(size, sp)
    assert n8 is not None and len(rows) == HEAD_CONVS == len({r[0] for r in rows}), rows
    for name, rows_in, rows_out, pad in rows:
        if ".global_branch." in name:
            assert rows_in == rows_out == 1, name
            continue
        scale = 2 ** (int(name.split(".")[2]) + 1) if name.startswith("decoder.") else 1
        assert rows_in == rows_out == n8 * scale + 2 * pad, (name, rows_in, rows_out)


def test_head_runs_on_bands_on_4_ranks(sp_forward_case):
    """{"data": 2, "sp": 2} at 64^2: each rank's head on 4 of the 8 rows at
    H/8 (and 8, 16, 32 of 16, 32, 64 in the decoder), with its halos;
    every output whole on both ranks of a spatial group
    (test_bf16_forward_on_4_ranks_matches_jax)."""
    _, _, ranks = sp_forward_case
    assert sorted(r["sp_index"] for r in ranks) == [0, 0, 1, 1]
    for r in ranks:
        assert_head_bands(r["head_rows"], 64, 2)
        assert r["out"]["predictions"][-1].shape == (2, 64, 64, 1)


@pytest.mark.parametrize("output", ["prediction 0", "prediction 1", "prediction 2", "edge",
                                    "context", "fused", "edge_features"])
def test_bf16_forward_on_4_ranks_matches_jax(sp_forward_case, output):
    """Each data index's rows, the same on both ranks of its spatial group,
    against JAX's sharded forward."""
    want, _, ranks = sp_forward_case

    def pick(out):
        if output.startswith("prediction"):
            return out["predictions"][int(output[-1])]
        return out["edge"] if output == "edge" else out["features"][output]

    by_index = {}
    for r in ranks:
        t = pick(r["out"])
        if r["data_index"] in by_index:
            assert torch.equal(t, by_index[r["data_index"]]), "a spatial group's ranks differ"
        by_index[r["data_index"]] = t
    got = torch.cat([by_index[d] for d in range(2)])
    mean_rel, max_rel = _rel(got, pick(want))
    assert mean_rel <= MEAN_REL and max_rel <= MAX_REL, (mean_rel, max_rel)


# -- (4) the train step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_train_case(tmp_path_factory):
    """The job (f64 SP_VARIANT weights, a batch of 4 and its first 3), the
    ranks' steps at each mesh (both meshes' ranks at once) and the one
    process's step on each global batch."""
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
    meshes = {"d1s2": {"data": 1, "sp": 2}, "d2s2": {"data": 2, "sp": 2}}
    jobs, runs = {}, {}
    for tag, spec in meshes.items():
        root = tmp_path_factory.mktemp(tag)
        jobs[tag] = {"state": model.state_dict(), "batches": [b4, b3], "config": config,
                     "mesh": spec, "variant": variant}
        torch.save(jobs[tag], root / "job.pt")
        runs[tag] = (root, workers.spawn(workers.sp_train_rank, spec["data"] * spec["sp"], root,
                                         join=False))
    ones = {}
    for tag, spec in meshes.items():
        for which, batch in enumerate((b4, b3)):
            if spec["data"] > 1:
                batch, w = sharding.pad_batch(batch, spec["data"])
                batch.sample_w = w
            ones[tag, which] = workers.train_step_result(jobs[tag], batch, 1)
    out = {}
    for tag, (root, ctx) in runs.items():
        while not ctx.join():
            pass
        n = meshes[tag]["data"] * meshes[tag]["sp"]
        out[tag] = [torch.load(root / f"sp_train_rank{r}.pt", weights_only=False)
                    for r in range(n)]
    return out, ones


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
@pytest.mark.parametrize("tag", ["d1s2", "d2s2"])
def test_sp_train_step_matches_one_process(sp_train_case, tag, which):
    ranks, ones = sp_train_case
    a, one = ranks[tag][0][which], ones[tag, which]
    assert a["rows"] == one["rows"] == (4, 3)[which]
    b_loc = 2 if tag == "d2s2" else (4, 3)[which]   # the tail padded to 4 over 2 data
    assert a["calls"] == [("fused_block_t", (b_loc, 128, 16)), ("qpool_front", (b_loc, 128, 16)),
                          ("global_ref", (b_loc, 8, 64))]
    np.testing.assert_allclose(a["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-12)
    _hold_grads(a["grads"], {n: g.numpy() for n, g in one["grads"].items()}, list(one["grads"]))
    for n in one["params"]:
        np.testing.assert_allclose(a["params"][n].numpy(), one["params"][n].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    for n in one["stats"]:
        np.testing.assert_allclose(a["stats"][n].numpy(), one["stats"][n].numpy(), rtol=1e-10,
                                   atol=1e-14, err_msg=n)
    for r in ranks[tag][1:]:
        b = r[which]
        for key in ("params", "stats"):
            for n in a[key]:
                assert torch.equal(a[key][n], b[key][n]), (key, n)
        assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("which", [0, 1], ids=["batch4", "tail3"])
@pytest.mark.parametrize("tag", ["d1s2", "d2s2"])
def test_sp_train_step_runs_the_head_on_bands(sp_train_case, tag, which):
    """In the train step each rank's head ran on its band of rows (the
    step itself: test_sp_train_step_matches_one_process)."""
    ranks, _ = sp_train_case
    got = sorted(r[which]["sp_index"] for r in ranks[tag])
    assert got == sorted([0, 1] * (len(ranks[tag]) // 2))
    for r in ranks[tag]:
        assert_head_bands(r[which]["head_rows"], 64, 2)


# -- (5) the evaluator ----------------------------------------------------------------

def test_sp_evaluate_matches_one_process(eval_workspace, tmp_path):
    """Batch 2 on {"data": 1, "sp": 2} (f32 down the token route) against
    batch 2 in one process: the same samples, metrics and files."""
    root, ds, ckpt = eval_workspace
    out = {}
    for world in (1, 2):
        job = {"base": str(tmp_path / f"w{world}"), "stamp": "run", "ckpt": str(ckpt),
               "model": MODEL, "batch": 2, "dataset": str(ds)}
        if world == 2:
            job.update(model={**MODEL, "spatial_axis": "sp"}, mesh={"data": 1, "sp": 2},
                       open_morton=True)
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
    assert list(two["samples"]) == list(one["samples"])
    for name, m in one["samples"].items():
        for k, v in m.items():
            assert abs(two["samples"][name][k] - v) <= 1e-5, (name, k)
    summary = json.loads((two_dir / "SYNTH" / "evaluation_summary.json").read_text())
    assert summary["timing"]["total_samples"] == len(one["samples"])
    assert summary["categories"] == one["summary"]["categories"]
    assert sorted(_tree(two_dir)) == sorted(_tree(one_dir))


@pytest.mark.parametrize("mode", ["predict", "evaluate"])
def test_cli_under_torchrun_with_a_spatial_config(eval_workspace, tmp_path, mode):
    """``python -m spegnet_tpu_torch predict|evaluate`` under
    ``torch.distributed.run`` with 2 CPU ranks, ``model.spatial_axis: sp``
    and ``parallel.mesh: {data: 1, sp: 2}``, against one process without
    the axis.  The checkpoint's f32 config keeps every block whole, so the
    files are the same bytes (predict: the PNGs; evaluate: the per-sample
    metrics) and as many."""
    import os
    import subprocess
    import sys

    import yaml

    root, ds, ckpt = eval_workspace
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(workers.Path(__file__).resolve().parents[1]),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    runs = {}
    for world in (1, 2):
        cwd = tmp_path / f"p{world}"
        cwd.mkdir()
        model = {**MODEL, "spatial_axis": "sp"} if world == 2 else MODEL
        mesh = {"data": 1, "sp": 2} if world == 2 else {"data": -1}
        cfg = cwd / "cfg.yaml"
        cfg.write_text(yaml.safe_dump({
            "model": model, "prediction": {"batch_size": 1}, "parallel": {"mesh": mesh},
            "training": {"canvas_buckets": [64, 128]},
            "evaluation": {"datasets": [str(ds)], "batch_size": 1,
                           "save_visualizations": False}}))
        args = ["-m", "spegnet_tpu_torch", mode, "--model", str(ckpt), "--config", str(cfg),
                "--device", "cpu"]
        if mode == "predict":
            args += ["--input", str(ds / "test" / "Imgs")]
        launch = ([sys.executable] if world == 1 else
                  [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   f"--nproc_per_node={world}"])
        proc = subprocess.run(launch + args, cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        run = list((cwd / "results" / ("prediction" if mode == "predict" else "evaluation")
                    / "runs").glob("run_*"))
        assert len(run) == 1, run
        runs[world] = run[0]
    one, two = _tree(runs[1]), _tree(runs[2])
    assert len(one) == (6 if mode == "predict" else 1) * 5
    assert one.keys() == two.keys() and all(one[k] == two[k] for k in one), [
        k for k in one if one[k] != two.get(k)]
    if mode == "evaluate":
        summary = json.loads((runs[2] / "SYNTH" / "evaluation_summary.json").read_text())
        assert summary["timing"]["total_samples"] == 5
