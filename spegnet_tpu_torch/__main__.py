"""Command line of the PyTorch port: ``predict`` with the arguments and output
tree of ``main.py predict``::

    python -m spegnet_tpu_torch predict --input path/to/image_or_dir \\
        [--model checkpoints/model.pth] [--config configs/default.yaml]

The checkpoint's embedded model config overlays the YAML's ``model``
section, as in ``main.py``.  ``train`` and ``evaluate`` are not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    from spegnet_tpu.config import DEFAULT_MODEL_PATH

    parser = argparse.ArgumentParser(
        prog="python -m spegnet_tpu_torch",
        description="SPEGNet camouflaged object detection (PyTorch / CUDA port)")
    parser.add_argument("mode", choices=["train", "evaluate", "predict"],
                        help="Operation mode (only predict is ported)")
    parser.add_argument("--config", type=Path,
                        help="Path to config file (default: configs/default.yaml)")
    parser.add_argument("--model", type=Path,
                        help=f"Path to a .pth checkpoint (default: {DEFAULT_MODEL_PATH})")
    parser.add_argument("--input", type=Path, help="Input image or directory")
    parser.add_argument("--device", help="torch device (default: cuda if available)")
    args = parser.parse_args(argv)
    if args.mode != "predict":
        parser.error(f"{args.mode} is not ported to PyTorch yet; use main.py")
    if not args.input:
        parser.error("predict mode requires --input argument")
    return args


def predict(config, model_path: Path, input_path: Path, dir_manager, device=None) -> None:
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

        from spegnet_tpu.config import DEFAULT_MODEL_PATH, load_config, overlay_checkpoint_config
        from spegnet_tpu.utils.run_manager import DirectoryManager, setup_logging
        from spegnet_tpu_torch.engine.model_loader import load_checkpoint_config

        args = parse_args(argv)
        dir_manager = DirectoryManager(args.mode)
        setup_logging(dir_manager)
        config = load_config(args.config)
        model_path = args.model or DEFAULT_MODEL_PATH
        config = overlay_checkpoint_config(config, load_checkpoint_config(str(model_path)))
        logging.info("Running in predict mode (PyTorch port)")
        logging.info("Configuration:\n" + yaml.dump(config, default_flow_style=False))
        predict(config, model_path, args.input, dir_manager, args.device)
        logging.info("Process completed successfully")
    except Exception as e:
        logging.error(f"Error occurred: {e}", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
