"""Command line of the PyTorch port, with the arguments and output trees of
``main.py``::

    python -m spegnet_tpu_torch train [--config configs/default.yaml] [--device cuda]
    python -m spegnet_tpu_torch evaluate [--model checkpoints/model.pth] \\
        [--config configs/default.yaml] [--device cuda]
    python -m spegnet_tpu_torch predict --input path/to/image_or_dir \\
        [--model checkpoints/model.pth] [--config configs/default.yaml] [--device cuda]

All three run on the card (``--device cuda``, the default; they fail
without one) unless ``--device cpu`` asks for the CPU.  ``train`` resumes
from the config's ``training.resume_from`` when it is set, and validates
after every epoch when ``training.val_ratio`` > 0.  For evaluate and
predict the checkpoint's embedded model config overlays the YAML's
``model`` section.  ``evaluate`` reads every ``{root}/test/{Imgs,GT}`` of
``evaluation.datasets`` and writes ``metrics_summary.json`` beside the
per-dataset trees.  Every run first logs the model report
(utils/model_info.py).

Data parallelism: under ``torchrun --nproc_per_node=N -m spegnet_tpu_torch
...`` each process joins the group first (parallel/mesh.init_distributed;
``--device cuda`` is then ``cuda:LOCAL_RANK``) and the config's
``parallel.mesh`` (default ``{data: -1}``, every process) divides each
batch over the ranks.  Rank 0 creates the run directory and writes the logs,
metrics and checkpoints; the other ranks write into the same tree (their
predictions and per-sample evaluation files) and log warnings only.

Sequence parallelism: ``model.spatial_axis: sp`` with ``parallel.mesh:
{data: D, sp: S}`` under ``torchrun --nproc_per_node=D*S`` splits the Morton
trunk's tokens over the S ranks of each data index (models/hiera.py
``trunk_plan``); those ranks take the same rows, and the one of spatial
index 0 writes their predictions and per-sample files.

Tensor parallelism: ``parallel.mesh: {data: D, model: M}`` under ``torchrun
--nproc_per_node=D*M`` splits the encoder's qkv, attention proj, fc1 and fc2
over the M ranks of each data index in training (engine/trainer.py); predict
and evaluate give those ranks the full weights and the rows of their data
index, as JAX does, and the one of model index 0 writes.

Both: ``model.spatial_axis: sp`` with ``parallel.mesh: {data: D, sp: S,
model: M}`` under ``torchrun --nproc_per_node=$((D*S*M))`` (the axes in any
order) splits the trunk's tokens over the S ranks of each spatial group
and, in training, the four matmuls over the M ranks of each model group;
the S M ranks of a data index take its rows, and the one of spatial and
model index 0 writes.

    python -m spegnet_tpu_torch edges <GT_dir> <Edges_dir> [--edge-width N] \
        [--threshold T] [--device cuda]

writes the edge maps of a directory of ground-truth masks (CAMO-style
datasets; utils/camo_edges.py) and prints its counts, as
``tools/generate_edges.py`` does with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path

from spegnet_tpu_torch.config import DEFAULT_MODEL_PATH


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m spegnet_tpu_torch",
        description="SPEGNet camouflaged object detection (PyTorch / CUDA port); "
        "edge maps of ground-truth masks: python -m spegnet_tpu_torch edges --help")
    parser.add_argument("mode", choices=["train", "evaluate", "predict"],
                        help="Operation mode")
    parser.add_argument("--config", type=Path,
                        help="Path to config file (default: configs/default.yaml)")
    parser.add_argument("--model", type=Path,
                        help=f"Path to a .pth checkpoint (default: {DEFAULT_MODEL_PATH})")
    parser.add_argument("--input", type=Path, help="Input image or directory")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if args.mode == "predict" and not args.input:
        parser.error("predict mode requires --input argument")
    return args


def train(config, dir_manager, device: str, mesh) -> None:
    from spegnet_tpu_torch.engine.trainer import Trainer

    dataset_paths = config["training"]["datasets"]
    if not dataset_paths:
        raise ValueError("No dataset paths provided in config")
    logging.info(f"Training on datasets: {dataset_paths}")
    trainer = Trainer(config, dir_manager, device=device, mesh=mesh)
    resume_path = config["training"].get("resume_from")
    if resume_path:
        trainer.load_checkpoint(resume_path, resume=True)
    trainer.train(dataset_paths)


def evaluate(config, model_path: Path, dir_manager, device: str, mesh) -> None:
    from spegnet_tpu_torch.data.dataset import get_test_datasets
    from spegnet_tpu_torch.engine.evaluator import Evaluator

    datasets = get_test_datasets(config["evaluation"]["datasets"])
    evaluator = Evaluator(
        model_path=str(model_path), dir_manager=dir_manager, model_config=config["model"],
        batch_size=config["evaluation"]["batch_size"],
        save_visualizations=config["evaluation"].get("save_visualizations", True),
        canvas_buckets=config["training"].get("canvas_buckets"), device=device, mesh=mesh)
    all_metrics = {}
    for name, dataset in datasets.items():
        logging.info(f"Evaluating on {name}")
        metrics = evaluator.evaluate(dataset, name)
        all_metrics[name] = metrics
        logging.info(f"S_alpha {metrics['s_alpha']:.4f}, weighted F {metrics['weighted_f']:.4f}, "
                     f"MAE {metrics['mae']:.4f}, E_phi {metrics['e_phi']:.4f}, "
                     f"mean F {metrics['mean_f']:.4f}")
    if mesh.rank:
        return
    metrics_path = dir_manager.run_dirs.root / "metrics_summary.json"
    with open(metrics_path, "w") as f:
        json.dump(all_metrics, f, indent=4)
    logging.info(f"Metrics saved to {metrics_path}")


def predict(config, model_path: Path, input_path: Path, dir_manager, device: str,
            mesh) -> None:
    from spegnet_tpu_torch.engine.predictor import Predictor

    predictor = Predictor(model_path=str(model_path), model_config=config["model"],
                          dir_manager=dir_manager,
                          batch_size=config["prediction"].get("batch_size"), device=device,
                          mesh=mesh)
    output_size = config["prediction"].get("output_size")
    if input_path.is_dir():
        results = predictor.predict_directory(str(input_path), output_size)
        logging.info(f"Processed {results['total_predictions']} images")
    elif mesh.data_index == 0:
        # one image does not divide over the data axis: data index 0 (its
        # spatial group) predicts it and rank 0 writes it
        seg, edge, original = predictor.predict_single(str(input_path), output_size)
        if mesh.rank == 0:
            predictor.result_manager.save_prediction(input_path.name, seg, edge, original)
        logging.info("Processing complete, results saved")


def print_model_info(config, model_axis: int = 1) -> None:
    """The model report (utils/model_info.py), as ``main.py`` logs it; a
    failure is a warning."""
    try:
        from spegnet_tpu_torch.utils.model_info import print_model_info as _pmi

        _pmi(config["model"], config["model"].get("image_processing", {}).get("target_size",
                                                                               512),
             model_axis)
    except Exception as e:
        logging.warning(f"Could not complete model analysis: {e}")


def run_directories(mode: str, rank: int):
    """The run's DirectoryManager: rank 0 makes the timestamped tree and the
    other ranks open the same one."""
    import torch.distributed as dist

    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    if not dist.is_initialized():
        return DirectoryManager(mode)
    stamp = [DirectoryManager(mode).timestamp if rank == 0 else None]
    dist.broadcast_object_list(stamp, 0)
    return DirectoryManager(mode, timestamp=stamp[0])


def edges(argv) -> None:
    """``edges <GT_dir> <Edges_dir> [--edge-width N] [--threshold T]
    [--device D]``: the edge maps of every ``*.png`` mask (utils/camo_edges.py),
    then the counts printed."""
    from spegnet_tpu_torch.utils.camo_edges import CAMOEdgeProcessor

    parser = argparse.ArgumentParser(prog="python -m spegnet_tpu_torch edges",
                                     description="Offline GT edge-map generation")
    parser.add_argument("input", help="Directory of GT masks (*.png)")
    parser.add_argument("output", help="Directory to write edge maps")
    parser.add_argument("--edge-width", type=int, default=1)
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Edge-continuity validation threshold")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    stats = CAMOEdgeProcessor(args.edge_width, args.threshold,
                              device=args.device).process_dataset(args.input, args.output)
    print(stats)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["edges"]:
        logging.basicConfig(level=logging.INFO)
        edges(argv[1:])
        return
    from spegnet_tpu_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
        mesh_from_config,
    )

    try:
        import yaml

        from spegnet_tpu_torch.config import load_config, overlay_checkpoint_config
        from spegnet_tpu_torch.engine.model_loader import load_checkpoint_config
        from spegnet_tpu_torch.utils.run_manager import setup_logging

        args = parse_args(argv)
        device, rank = args.device, 0
        if "WORLD_SIZE" in os.environ:   # under torchrun: join the group first
            device = str(init_distributed(args.device))
            rank = int(os.environ["RANK"])
        dir_manager = run_directories(args.mode, rank)
        setup_logging(dir_manager if rank == 0 else None)
        config = load_config(args.config)
        if args.mode in ("evaluate", "predict"):
            model_path = args.model or DEFAULT_MODEL_PATH
            config = overlay_checkpoint_config(config, load_checkpoint_config(str(model_path)))
        mesh = mesh_from_config(config.get("parallel"),
                                spatial_axis=config["model"].get("spatial_axis"))
        logging.info(f"Running in {args.mode} mode (PyTorch port), mesh {mesh.shape}")
        logging.info("Configuration:\n" + yaml.dump(config, default_flow_style=False))
        if rank == 0:
            print_model_info(config, mesh.model)
        if args.mode == "train":
            train(config, dir_manager, device, mesh)
        elif args.mode == "evaluate":
            evaluate(config, model_path, dir_manager, device, mesh)
        else:
            predict(config, model_path, args.input, dir_manager, device, mesh)
        logging.info("Process completed successfully")
    except Exception as e:
        logging.error(f"Error occurred: {e}", exc_info=True)
        sys.exit(1)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
