"""Run directories and logging (port of spegnet_tpu/utils/run_manager.py).

The results tree is the reference's:

    results/
    ├── training/runs/run_{ts}/{checkpoints/, metrics.json, training_log.txt}
    ├── evaluation/runs/run_{ts}/evaluation_log.txt
    └── prediction/runs/run_{ts}/{results/{segmentation,edges}/, prediction_log.txt}
"""

from __future__ import annotations

import dataclasses
import logging
from datetime import datetime
from enum import Enum
from pathlib import Path
from typing import Dict, Optional


class RunMode(Enum):
    TRAIN = "training"
    EVALUATE = "evaluation"
    PREDICT = "prediction"


@dataclasses.dataclass
class RunDirectories:
    root: Path
    checkpoints: Optional[Path] = None
    visualizations: Optional[Path] = None
    metrics_file: Optional[Path] = None
    log_file: Optional[Path] = None


class DirectoryManager:
    """Creates the timestamped run directory tree for a mode (``timestamp``:
    open the tree of that run, as the ranks of a data-parallel run do)."""

    def __init__(self, mode: str, base_dir: str = "results", timestamp: Optional[str] = None):
        self.mode = RunMode[mode.upper()].value
        self.timestamp = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
        self.base_dir = Path(base_dir)
        self.run_dirs = self._setup_directories()

    def _setup_directories(self) -> RunDirectories:
        root = self.base_dir / self.mode / "runs" / f"run_{self.timestamp}"
        run_dirs = RunDirectories(root=root)
        root.mkdir(parents=True, exist_ok=True)
        if self.mode == RunMode.TRAIN.value:
            run_dirs.checkpoints = root / "checkpoints"
            run_dirs.checkpoints.mkdir(parents=True, exist_ok=True)
            run_dirs.metrics_file = root / "metrics.json"
            run_dirs.log_file = root / "training_log.txt"
        elif self.mode == RunMode.EVALUATE.value:
            run_dirs.log_file = root / "evaluation_log.txt"
        else:
            run_dirs.visualizations = root / "results"
            (run_dirs.visualizations / "segmentation").mkdir(parents=True, exist_ok=True)
            (run_dirs.visualizations / "edges").mkdir(parents=True, exist_ok=True)
            run_dirs.log_file = root / "prediction_log.txt"
        return run_dirs

    def get_paths(self) -> Dict[str, Path]:
        return {f.name: getattr(self.run_dirs, f.name)
                for f in dataclasses.fields(self.run_dirs)
                if getattr(self.run_dirs, f.name) is not None}


def setup_logging(dir_manager: Optional[DirectoryManager]) -> None:
    """Console + per-run file logging; without a directory manager (the
    ranks of a data-parallel run but rank 0) warnings on the console only."""
    handlers = [logging.StreamHandler()]
    if dir_manager is not None:
        handlers.append(logging.FileHandler(dir_manager.run_dirs.log_file))
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(message)s",
        level=logging.INFO if dir_manager is not None else logging.WARNING,
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
        force=True,
    )
