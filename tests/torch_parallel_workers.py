"""Rank programs for tests/test_torch_parallel.py: each runs in a process
that torch.multiprocessing spawns, joins a gloo group through a file store
and writes what it computed beside it.  They import torch and the port
only, so a rank starts without JAX."""

from pathlib import Path

import torch

from spegnet_tpu_torch.parallel.mesh import create_mesh, destroy_distributed, init_distributed


def spawn(fn, world: int, root: Path, join: bool = True):
    """Run ``fn(rank, world, root)`` in ``world`` processes and wait for them,
    or, without ``join``, return their torch.multiprocessing context."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(world, str(root)), nprocs=world, join=join,
                              start_method="spawn")


def _join(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", f"file://{root}/store", rank, world)


def train_step_result(job: dict, batch, world: int) -> dict:
    """One Trainer step of ``job``'s model (f64) on ``batch`` under a data
    axis of ``world``: the global losses, the reduced gradients before the
    clip, the updated parameters and running statistics."""
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    model = SPEGNet(SPEGNetConfig(variant="test", compute_dtype="float64")).double()
    model.load_state_dict(job["state"])
    trainer = Trainer(job["config"], None, device="cpu", model=model,
                      mesh=create_mesh({"data": world}, world))
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
        dm = DirectoryManager("evaluate", base_dir=job["base"], timestamp=job["stamp"])
        ev = Evaluator(job["ckpt"], dm, job["model"], batch_size=job["batch"],
                       save_visualizations=True, canvas_buckets=(64, 128), device="cpu",
                       mesh=create_mesh({"data": world}, world))
        name = Path(job["dataset"]).name
        means = ev.evaluate(get_test_datasets([job["dataset"]])[name], name)
        torch.save({"means": means, "samples": ev.sample_metrics[name],
                    "summary": ev.summaries[name]}, Path(root) / f"evaluate_rank{rank}.pt")
    finally:
        destroy_distributed()
