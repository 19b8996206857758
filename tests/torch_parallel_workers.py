"""Rank programs for tests/test_torch_parallel.py and
tests/test_torch_spatial.py: each runs in a process that
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


def register_sp_variant() -> str:
    thiera.HIERA_VARIANTS["_sp"] = SP_VARIANT
    return "_sp"


def open_morton() -> None:
    """Send any compute dtype down the sequence-parallel Morton routes (the
    gate is bf16 only), so that f64 and f32 models take them."""
    thiera.sp_takes_morton = lambda h, w, dtype: h == w and h & (h - 1) == 0


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


def spawn(fn, world: int, root: Path, join: bool = True):
    """Run ``fn(rank, world, root)`` in ``world`` processes and wait for them,
    or, without ``join``, return their torch.multiprocessing context."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(world, str(root)), nprocs=world, join=join,
                              start_method="spawn")


def _join(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{root}/store", rank, world)


def train_step_result(job: dict, batch, world) -> dict:
    """One Trainer step of ``job``'s model (f64; its ``variant``, default
    "test") on ``batch`` under a data axis of ``world``, or on ``world``'s
    mesh when it is one (the model then takes its spatial axis): the global
    losses, the reduced gradients before the clip, the updated parameters
    and running statistics."""
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    mesh = world if isinstance(world, Mesh) else create_mesh({"data": world}, world)
    model = SPEGNet(SPEGNetConfig(variant=job.get("variant", "test"), compute_dtype="float64",
                                  spatial_axis=mesh.spatial_axis)).double()
    model.load_state_dict(job["state"])
    trainer = Trainer(job["config"], None, device="cpu", model=model, mesh=mesh)
    grads = {}
    clip_and_step = trainer.clip_and_step

    def snapshot():
        grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        clip_and_step()

    trainer.clip_and_step = snapshot
    res = trainer.train_step(batch)
    return {"metrics": res["metrics"], "rows": res["rows"], "grads": grads,
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            "stats": {n: b.clone() for n, b in trainer.model.named_buffers() if "running" in n}}


def train_rank(rank: int, world: int, root: str) -> None:
    """Every batch of ``root``/job.pt through :func:`train_step_result`."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        out = [train_step_result(job, batch, world) for batch in job["batches"]]
        torch.save(out, Path(root) / f"train_rank{rank}.pt")
    finally:
        destroy_distributed()


def evaluate_rank(rank: int, world: int, root: str) -> None:
    """The Evaluator on ``root``/job.pt's dataset, writing under ``base``
    with the run's timestamp, and its means and per-sample metrics."""
    from spegnet_tpu_torch.data.dataset import get_test_datasets
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        if job.get("open_morton"):
            open_morton()
        dm = DirectoryManager("evaluate", base_dir=job["base"], timestamp=job["stamp"])
        ev = Evaluator(job["ckpt"], dm, job["model"], batch_size=job["batch"],
                       save_visualizations=True, canvas_buckets=(64, 128), device="cpu",
                       mesh=create_mesh(job.get("mesh", {"data": world}), world,
                                        job["model"].get("spatial_axis")))
        name = Path(job["dataset"]).name
        means = ev.evaluate(get_test_datasets([job["dataset"]])[name], name)
        torch.save({"means": means, "samples": ev.sample_metrics[name],
                    "summary": ev.summaries[name]}, Path(root) / f"evaluate_rank{rank}.pt")
    finally:
        destroy_distributed()


def sp_train_rank(rank: int, world: int, root: str) -> None:
    """Every batch of ``root``/job.pt through :func:`train_step_result` on the
    job's mesh (a spatial axis "sp"), the f64 model on the Morton routes
    (:func:`open_morton`), with the trunk's calls of its first step."""
    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        register_sp_variant()
        open_morton()
        mesh = create_mesh(job["mesh"], world, "sp")
        calls = record_calls()
        out = []
        for batch in job["batches"]:
            out.append(train_step_result(job, batch, mesh))
            out[-1]["calls"], calls[:] = list(calls), []
        torch.save(out, Path(root) / f"sp_train_rank{rank}.pt")
    finally:
        destroy_distributed()


def sp_forward_rank(rank: int, world: int, root: str) -> None:
    """The eval-mode SPEGNet of ``root``/job.pt (its variant and compute
    dtype, spatial axis "sp" over the job's mesh) on this rank's rows of
    the job's input: its outputs and the trunk's calls."""
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.parallel.sharding import rows_of

    _join(rank, world, root)
    try:
        job = torch.load(Path(root) / "job.pt", weights_only=False)
        mesh = create_mesh(job["mesh"], world, "sp")
        model = SPEGNet(SPEGNetConfig(variant=job["variant"], compute_dtype=job["dtype"],
                                      spatial_axis="sp")).eval()
        model.load_state_dict(job["state"])
        model.to_compute().shard_tokens(mesh.token_shard)
        x = job["x"][rows_of(mesh.data_index, mesh.data, job["x"].shape[0])]
        calls = record_calls()
        with torch.no_grad():
            out = model(x)
        torch.save({"out": out, "calls": calls, "data_index": mesh.data_index},
                   Path(root) / f"sp_forward_rank{rank}.pt")
    finally:
        destroy_distributed()
