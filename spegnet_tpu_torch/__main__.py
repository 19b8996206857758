"""Command line of the PyTorch port, with the arguments and output trees of
``main.py``::

    python -m spegnet_tpu_torch train [--config configs/default.yaml] [--device cuda]
    python -m spegnet_tpu_torch evaluate [--model checkpoints/model.pth] \\
        [--config configs/default.yaml] [--device cuda]
    python -m spegnet_tpu_torch predict --input path/to/image_or_dir \\
        [--model checkpoints/model.pth] [--config configs/default.yaml] [--device cuda]

All three run on the card (``--device cuda``, the default; they fail
without one) unless ``--device cpu`` asks for the CPU.  ``train`` resumes
from the config's ``training.resume_from`` when it is set and needs
``training.val_ratio: 0`` (validation is not ported yet).  For evaluate and
predict the checkpoint's embedded model config overlays the YAML's
``model`` section.  ``evaluate`` reads every ``{root}/test/{Imgs,GT}`` of
``evaluation.datasets`` and writes ``metrics_summary.json`` beside the
per-dataset trees.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

from spegnet_tpu_torch.config import DEFAULT_MODEL_PATH


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m spegnet_tpu_torch",
        description="SPEGNet camouflaged object detection (PyTorch / CUDA port)")
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


def train(config, dir_manager, device: str) -> None:
    from spegnet_tpu_torch.engine.trainer import Trainer

    dataset_paths = config["training"]["datasets"]
    if not dataset_paths:
        raise ValueError("No dataset paths provided in config")
    logging.info(f"Training on datasets: {dataset_paths}")
    trainer = Trainer(config, dir_manager, device=device)
    resume_path = config["training"].get("resume_from")
    if resume_path:
        trainer.load_checkpoint(resume_path, resume=True)
    trainer.train(dataset_paths)


def evaluate(config, model_path: Path, dir_manager, device: str) -> None:
    from spegnet_tpu_torch.data.dataset import get_test_datasets
    from spegnet_tpu_torch.engine.evaluator import Evaluator

    datasets = get_test_datasets(config["evaluation"]["datasets"])
    evaluator = Evaluator(
        model_path=str(model_path), dir_manager=dir_manager, model_config=config["model"],
        batch_size=config["evaluation"]["batch_size"],
        save_visualizations=config["evaluation"].get("save_visualizations", True),
        canvas_buckets=config["training"].get("canvas_buckets"), device=device)
    all_metrics = {}
    for name, dataset in datasets.items():
        logging.info(f"Evaluating on {name}")
        metrics = evaluator.evaluate(dataset, name)
        all_metrics[name] = metrics
        logging.info(f"S_alpha {metrics['s_alpha']:.4f}, weighted F {metrics['weighted_f']:.4f}, "
                     f"MAE {metrics['mae']:.4f}, E_phi {metrics['e_phi']:.4f}, "
                     f"mean F {metrics['mean_f']:.4f}")
    metrics_path = dir_manager.run_dirs.root / "metrics_summary.json"
    with open(metrics_path, "w") as f:
        json.dump(all_metrics, f, indent=4)
    logging.info(f"Metrics saved to {metrics_path}")


def predict(config, model_path: Path, input_path: Path, dir_manager, device: str) -> None:
    from spegnet_tpu_torch.engine.predictor import Predictor

    predictor = Predictor(model_path=str(model_path), model_config=config["model"],
                          dir_manager=dir_manager,
                          batch_size=config["prediction"].get("batch_size"), device=device)
    output_size = config["prediction"].get("output_size")
    if input_path.is_dir():
        results = predictor.predict_directory(str(input_path), output_size)
        logging.info(f"Processed {results['total_predictions']} images")
    else:
        seg, edge, original = predictor.predict_single(str(input_path), output_size)
        predictor.result_manager.save_prediction(input_path.name, seg, edge, original)
        logging.info("Processing complete, results saved")


def main(argv=None) -> None:
    try:
        import yaml

        from spegnet_tpu_torch.config import load_config, overlay_checkpoint_config
        from spegnet_tpu_torch.engine.model_loader import load_checkpoint_config
        from spegnet_tpu_torch.utils.run_manager import DirectoryManager, setup_logging

        args = parse_args(argv)
        dir_manager = DirectoryManager(args.mode)
        setup_logging(dir_manager)
        config = load_config(args.config)
        if args.mode in ("evaluate", "predict"):
            model_path = args.model or DEFAULT_MODEL_PATH
            config = overlay_checkpoint_config(config, load_checkpoint_config(str(model_path)))
        logging.info(f"Running in {args.mode} mode (PyTorch port)")
        logging.info("Configuration:\n" + yaml.dump(config, default_flow_style=False))
        if args.mode == "train":
            train(config, dir_manager, args.device)
        elif args.mode == "evaluate":
            evaluate(config, model_path, dir_manager, args.device)
        else:
            predict(config, model_path, args.input, dir_manager, args.device)
        logging.info("Process completed successfully")
    except Exception as e:
        logging.error(f"Error occurred: {e}", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
