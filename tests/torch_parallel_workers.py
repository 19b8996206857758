"""Rank programs for tests/test_torch_parallel.py,
tests/test_torch_spatial.py, tests/test_torch_tensor_parallel.py and
tests/test_torch_sp_model.py: each runs in a process that
torch.multiprocessing spawns, joins a gloo group through a file store and
writes what it computed beside it.  They import torch and the port only, so
a rank starts without JAX."""

from pathlib import Path

import torch

from spegnet_tpu_torch.models import hiera as thiera
from spegnet_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    destroy_distributed,
    init_distributed,
)

# A small trunk whose sequence-parallel routes at 64^2 (patch grid 16, S = 2)
# reach every case of models/hiera.trunk_plan: a sharded T-block and front,
# a block that leaves the token shards (the T-block's gate refuses 32 local
# tokens), a whole transition, a global block that takes them again
# ("global_ref", its K / V gathered) and a transition whose front the local
# gate refuses after it.
SP_VARIANT = thiera.HieraConfig(16, 1, (1, 2, 2, 1), (4,), (7, 7), (4, 2, 2, 2))


# A small trunk whose blocks at 384^2 (patch grid 96) take Hiera-L's routes
# there: the gen-1 block on stage 1 and 2's divisible windows, the lanes
# attention on stage 3 and 4's windows that do not divide their grids and on
# the global block; the transitions decomposed (plain attention).  Every
# stage's heads divide over a model axis of 2.
LANES_VARIANT = thiera.HieraConfig(16, 2, (1, 2, 3, 2), (5,), (7, 7), (8, 4, 16, 8))


def register_lanes_variant() -> str:
    thiera.HIERA_VARIANTS["_lanes"] = LANES_VARIANT
    return "_lanes"


def register_sp_variant() -> str:
    thiera.HIERA_VARIANTS["_sp"] = SP_VARIANT
    return "_sp"


def open_morton() -> None:
    """Send any compute dtype down the sequence-parallel Morton routes (the
    gate is bf16 only), so that f64 and f32 models take them."""
    thiera.sp_takes_morton = lambda h, w, dtype: h == w and h & (h - 1) == 0


def open_morton_any_dtype() -> None:
    """Send any compute dtype down the Morton trunk of one process (T-block,
    front, gen-1 on the last stage; the gate is bf16 only)."""
    thiera.takes_morton = lambda cfg, h, w, dtype: thiera.morton_grid(cfg, h, w)


def record_calls() -> list:
    """(route, token-major input shape) of every call of the trunk's T-block,
    front and sequence-parallel global block, in order, from now on."""
    from spegnet_tpu_torch.ops import fused_block_t as fbt

    calls = []
    for mod, name, route in ((thiera, "fused_block_t", "fused_block_t"),
                             (thiera, "qpool_front", "qpool_front"),
                             (fbt, "block_global_sp", "global_ref")):
        fn = getattr(mod, name)
        setattr(mod, name, lambda x, *a, _fn=fn, _r=route, **k:
                calls.append((_r, tuple(x.shape))) or _fn(x, *a, **k))
    return calls


def record_head_rows(model) -> list:
    """(module, rows in, rows out, its row padding) of every convolution of
    ``model``'s head that runs as a module (all but the fusion's per-stage
    1x1 projection), in call order, from now on: under row bands each runs
    on this rank's band with its halo."""
    rows = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and not name.startswith("encoder"):
            mod.register_forward_hook(lambda m, args, out, _n=name: rows.append(
                (_n, args[0].shape[2], out.shape[2], m.padding[0])))
    return rows


def spawn(fn, world: int, root: Path, join: bool = True):
    """Run ``fn(rank, world, root)`` in ``world`` processes and wait for them,
    or, without ``join``, return their torch.multiprocessing context."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(world, str(root)), nprocs=world, join=join,
                              start_method="spawn")


def _join(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{root}/store", rank, world)


def make_trainer(job: dict, mesh: Mesh):
    """A Trainer of ``job``'s model (f64; its ``variant``, default "test";
    its ``state``) on ``mesh`` (the model takes its spatial and model axes)."""
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    model = SPEGNet(SPEGNetConfig(variant=job.get("variant", "test"), compute_dtype="float64",
                                  spatial_axis=mesh.spatial_axis)).double()
    model.load_state_dict(job["state"])
    return Trainer(job["config"], None, device="cpu", model=model, mesh=mesh)


def step_result(trainer, batch) -> dict:
    """One step of ``trainer`` on ``batch``: the global losses, the reduced
    gradients before the clip, the updated parameters and running
    statistics; under a model axis every shard gathered (the full tensors),
    so every rank of a model group calls it."""
    from spegnet_tpu_torch.parallel.sharding import gather_param

    grads = {}
    clip_and_step = trainer.clip_and_step

    def snapshot():
        grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        clip_and_step()

    trainer.clip_and_step = snapshot
    res = trainer.train_step(batch)
    trainer.clip_and_step = clip_and_step
    shard = trainer.mesh.model_shard

    def full(n, t):
        return t if shard is None else gather_param(n, t, shard)

    return {"metrics": res["metrics"], "rows": res["rows"],
            "grads": {n: full(n, g) for n, g in grads.items()},
            "params": {n: full(n, p.detach().clone())
                       for n, p in trainer.model.named_parameters()},
            "stats": {n: b.clone() for n, b in trainer.model.named_buffers() if "running" in n}}


def train_step_result(job: dict, batch, world) -> dict:
    """:func:`step_result` of a fresh :func:`make_trainer` under a data axis
    of ``world``, or on ``world``'s mesh when it is one."""
    mesh = world if isinstance(world, Mesh) else create_mesh({"data": world}, world)
    return step_result(make_trainer(job, mesh), batch)


def train_rank(rank: int, world: int, root: str) -> None:
    """Every batch of ``root``/job.pt through :func:`train_step_result`."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        out = [train_step_result(job, batch, world) for batch in job["batches"]]
        torch.save(out, Path(root) / f"train_rank{rank}.pt")
    finally:
        destroy_distributed()


def evaluate_result(job: dict, world: int) -> dict:
    """The Evaluator on ``job``'s dataset, writing under ``base`` with the
    run's timestamp, on the job's mesh: its means, per-sample metrics and
    summary."""
    from spegnet_tpu_torch.data.dataset import get_test_datasets
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    dm = DirectoryManager("evaluate", base_dir=job["base"], timestamp=job["stamp"])
    ev = Evaluator(job["ckpt"], dm, job["model"], batch_size=job["batch"],
                   save_visualizations=True, canvas_buckets=(64, 128), device="cpu",
                   mesh=create_mesh(job.get("mesh", {"data": world}), world,
                                    job["model"].get("spatial_axis")))
    name = Path(job["dataset"]).name
    means = ev.evaluate(get_test_datasets([job["dataset"]])[name], name)
    return {"means": means, "samples": ev.sample_metrics[name], "summary": ev.summaries[name]}


def evaluate_rank(rank: int, world: int, root: str) -> None:
    """:func:`evaluate_result` of ``root``/job.pt."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        if job.get("open_morton"):
            open_morton()
        torch.save(evaluate_result(job, world), Path(root) / f"evaluate_rank{rank}.pt")
    finally:
        destroy_distributed()


def sp_train_rank(rank: int, world: int, root: str) -> None:
    """Every batch of ``root``/job.pt through :func:`train_step_result` on the
    job's mesh (a spatial axis "sp"), the f64 model on the Morton routes
    (:func:`open_morton`), with the trunk's calls of its first step and the
    head's rows (:func:`record_head_rows`)."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        register_sp_variant()
        open_morton()
        mesh = create_mesh(job["mesh"], world, "sp")
        calls = record_calls()
        out = []
        for batch in job["batches"]:
            tr = make_trainer(job, mesh)
            head = record_head_rows(tr.model)
            out.append(step_result(tr, batch))
            out[-1]["calls"], calls[:] = list(calls), []
            out[-1]["head_rows"], out[-1]["sp_index"] = head, mesh.sp_index
        torch.save(out, Path(root) / f"sp_train_rank{rank}.pt")
    finally:
        destroy_distributed()


def sp_forward_result(job: dict, mesh: Mesh) -> dict:
    """The eval-mode SPEGNet of ``job`` (its variant and compute dtype,
    spatial axis "sp" over ``mesh``, its matmuls split over the mesh's model
    axis if it has one) on this rank's rows of the job's input: its outputs,
    the trunk's calls and the head's rows (:func:`record_head_rows`)."""
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.parallel.sharding import rows_of

    model = SPEGNet(SPEGNetConfig(variant=job["variant"], compute_dtype=job["dtype"],
                                  spatial_axis="sp")).eval()
    model.load_state_dict(job["state"])
    model.to_compute().shard_tokens(mesh.token_shard).shard_model(mesh.model_shard)
    x = job["x"][rows_of(mesh.data_index, mesh.data, job["x"].shape[0])]
    calls, head = record_calls(), record_head_rows(model)
    with torch.no_grad():
        out = model(x)
    return {"out": out, "calls": list(calls), "data_index": mesh.data_index,
            "sp_index": mesh.sp_index, "head_rows": head}


def sp_forward_rank(rank: int, world: int, root: str) -> None:
    """:func:`sp_forward_result` of ``root``/job.pt on the job's mesh."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        torch.save(sp_forward_result(job, create_mesh(job["mesh"], world, "sp")),
                   Path(root) / f"sp_forward_rank{rank}.pt")
    finally:
        destroy_distributed()


def trunk_result(job: dict, shard=None) -> dict:
    """The f64 trunk of :data:`LANES_VARIANT` (``job``'s ``trunk_state``) on
    ``trunk_x`` through
    the kernel path (sharded over ``shard``, a model group): the stage
    outputs, every trunk parameter's gradient of sum(output * cotangent)
    (under the model axis the loss scaled by 1 / M, the replicated
    gradients summed over the group, the shards gathered: the trainer's
    rule), and the (L, heads) of every ``fused_attention_lanes`` call."""
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.parallel import sharding

    model = SPEGNet(SPEGNetConfig(variant=register_lanes_variant(),
                                  compute_dtype="float64")).double()
    model.load_state_dict(job["trunk_state"])
    model.shard_model(shard)
    calls, lanes = [], thiera.fused_attention_lanes
    thiera.fused_attention_lanes = lambda qkv, heads, *a, **k: (
        calls.append((qkv.shape[1], heads)) or lanes(qkv, heads, *a, **k))
    try:
        feats = model.encoder.encoder(job["trunk_x"], kernels=True, dtype=torch.float64)
    finally:
        thiera.fused_attention_lanes = lanes
    m = 1 if shard is None else shard.size
    loss = sum((f * c).sum() for f, c in zip(feats, job["trunk_cot"])) / m
    loss.backward()
    grads = {}
    for n, p in model.encoder.named_parameters():
        n = "encoder." + n
        g = p.grad
        if shard is not None:
            g = (sharding.gather_param(n, g, shard) if sharding.shard_dim(n) is not None
                 else sharding.all_reduce_sum(g, shard.group))
        grads[n] = g
    return {"feats": [f.detach() for f in feats], "grads": grads, "lanes": calls}


def tp_rank(rank: int, world: int, root: str) -> None:
    """The tensor-parallel tasks of ``root``/job.pt on its mesh (a model
    axis): ``steps`` (a fresh Trainer's step on each batch), ``morton_steps``
    (the same on the Morton trunk's kernel routes, opened to f64),
    ``checkpoint`` (a step on batch 0, its checkpoint_state written by rank
    0 as tp_ckpt.pth, then a step on batch 1; and a Trainer resumed from
    one_ckpt.pth, a step on batch 1), ``trunk`` (:func:`trunk_result`) and
    ``evaluate`` (:func:`evaluate_result` of the job's ``eval`` job)."""
    _join(rank, world, root)
    try:
        root = Path(root)
        job = torch.load(root / "job.pt", weights_only=False)
        mesh = create_mesh(job["mesh"], world)
        out = {"model_index": mesh.model_index, "data_index": mesh.data_index}
        tasks = job["tasks"]
        if "steps" in tasks:
            out["steps"] = [train_step_result(job, b, mesh) for b in job["batches"]]
        if "checkpoint" in tasks:
            tr = make_trainer(job, mesh)
            step_result(tr, job["batches"][0])
            state = tr.checkpoint_state(0, {})
            if rank == 0:
                torch.save(state, root / "tp_ckpt.pth")
            out["after_ckpt"] = step_result(tr, job["batches"][1])
            tr = make_trainer(job, mesh)
            tr.load_checkpoint(root / "one_ckpt.pth", resume=True)
            out["from_one"] = step_result(tr, job["batches"][1])
        if "trunk" in tasks:
            out["trunk"] = trunk_result(job, mesh.model_shard)
        if "evaluate" in tasks:
            out["evaluate"] = evaluate_result(job["eval"], world)
        if "morton_steps" in tasks:
            open_morton_any_dtype()
            out["morton_steps"] = [train_step_result(job, b, mesh) for b in job["batches"]]
        torch.save(out, root / f"tp_rank{rank}.pt")
    finally:
        destroy_distributed()


def mesh_record(mesh: Mesh) -> dict:
    """A rank's indices and the ranks of each sub-group its mesh made."""
    import torch.distributed as dist

    groups = {}
    for name in ("sp_group", "model_group", "data_group", "replica_group"):
        g = getattr(mesh, name)
        groups[name] = None if g is None else dist.get_process_group_ranks(g)
    return {"data_index": mesh.data_index, "sp_index": mesh.sp_index,
            "model_index": mesh.model_index, "lead": mesh.lead, "groups": groups}


def sp_model_rank(rank: int, world: int, root: str) -> None:
    """The tasks of ``root``/job.pt on its mesh (the spatial axis "sp" and a
    model axis): the mesh's groups; ``steps`` (a fresh Trainer's step on
    each batch of ``SP_VARIANT``, f64 on the token route, :func:`open_morton`;
    with the rank's own parameters, the trunk's calls and the head's rows); ``remat_steps``
    (the same with ``training.remat``); ``oracle_steps`` (the job's
    ``oracle`` job, the same way); ``checkpoint`` (a step on batch 0, its
    checkpoint_state written by rank 0 as sp_model_ckpt.pth, a step on batch
    1; a Trainer resumed from one_ckpt.pth, a step on batch 1); ``evaluate``
    (:func:`evaluate_result` of the job's ``eval`` job)."""
    _join(rank, world, root)
    try:
        root = Path(root)
        job = torch.load(root / "job.pt", weights_only=False)
        register_sp_variant()
        open_morton()
        mesh = create_mesh(job["mesh"], world, "sp")
        out = {"mesh": mesh_record(mesh)}
        tasks = job["tasks"]
        if "forward" in tasks:
            out["forward"] = sp_forward_result(job["forward"], mesh)
        calls = record_calls()

        def steps(j):
            res = []
            for batch in j["batches"]:
                tr = make_trainer(j, mesh)
                calls[:] = []
                head = record_head_rows(tr.model)
                res.append(step_result(tr, batch))
                res[-1]["calls"], res[-1]["head_rows"] = list(calls), head
                res[-1]["local"] = {n: p.detach().clone()
                                    for n, p in tr.model.named_parameters()}
            return res

        if "steps" in tasks:
            out["steps"] = steps(job)
        if "remat_steps" in tasks:
            conf = {**job["config"], "training": {**job["config"]["training"], "remat": True}}
            out["remat_steps"] = steps({**job, "config": conf})
        if "oracle_steps" in tasks:
            out["oracle_steps"] = steps(job["oracle"])
        if "checkpoint" in tasks:
            tr = make_trainer(job, mesh)
            step_result(tr, job["batches"][0])
            state = tr.checkpoint_state(0, {})
            if rank == 0:
                torch.save(state, root / "sp_model_ckpt.pth")
            out["after_ckpt"] = step_result(tr, job["batches"][1])
            tr = make_trainer(job, mesh)
            tr.load_checkpoint(root / "one_ckpt.pth", resume=True)
            out["from_one"] = step_result(tr, job["batches"][1])
        if "evaluate" in tasks:
            out["evaluate"] = evaluate_result(job["eval"], world)
        torch.save(out, root / f"sp_model_rank{rank}.pt")
    finally:
        destroy_distributed()
