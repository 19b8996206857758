"""Prediction engine (port of spegnet_tpu/engine/predictor.py).

Single-image and batched directory inference with the reference's output
tree: 6 PNGs per image (segmentation and edge maps, each as binary /
heatmap / overlay) and ``prediction_summary.json``.  The model runs on
``device`` (the card unless the caller asks for the CPU) in the config's
compute dtype through the kernel path; OpenCV and Pillow are imported only
where files are written or decoded.
"""

from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spegnet_tpu_torch.data.pipeline import ImageProcessor
from spegnet_tpu_torch.engine.model_loader import load_checkpoint
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops.resize import resize_bilinear
from spegnet_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class PredictionResultManager:
    def __init__(self, dir_manager):
        self.run_dirs = dir_manager.run_dirs
        self.viz_root = self.run_dirs.visualizations
        self.seg_dir = self.viz_root / "segmentation"
        self.edge_dir = self.viz_root / "edges"
        for sub in ("binary", "heatmap", "overlay"):
            (self.seg_dir / sub).mkdir(parents=True, exist_ok=True)
            (self.edge_dir / sub).mkdir(parents=True, exist_ok=True)
        self.log_file = self.run_dirs.log_file
        self.timings = {"preprocessing": [], "inference": [], "postprocessing": []}

    def log_message(self, message: str):
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.log_file, "a") as f:
            f.write(f"[{ts}] {message}\n")

    def save_prediction(self, filename: str, seg_pred: np.ndarray,
                        edge_pred: np.ndarray, original_image: np.ndarray):
        from spegnet_tpu_torch.utils.visualization import (
            save_binary_visualization,
            save_heatmap_visualization,
            save_overlay_visualization,
        )

        base = Path(filename).stem
        for root, pred in ((self.seg_dir, seg_pred), (self.edge_dir, edge_pred)):
            save_binary_visualization(pred, root / "binary" / f"{base}.png")
            save_heatmap_visualization(pred, root / "heatmap" / f"{base}.png", normalize=True)
            save_overlay_visualization(original_image, pred, root / "overlay" / f"{base}.png")

    def update_timing(self, phase: str, dt: float):
        self.timings[phase].append(dt)

    def summarize(self) -> Dict:
        n = len(list((self.seg_dir / "binary").glob("*.png")))
        avg = {p: (float(np.mean(t)) if t else 0.0) for p, t in self.timings.items()}
        total = sum(avg.values())
        summary = {
            "total_predictions": n,
            "average_timings": avg,
            "total_time_per_image": total,
            "total_processing_time": total * n,
        }
        with open(self.run_dirs.root / "prediction_summary.json", "w") as f:
            json.dump(summary, f, indent=4)
        self.log_message(
            f"\nPrediction Summary:\nTotal images processed: {n}\n"
            f"Average timings (s): pre {avg['preprocessing']:.3f} / "
            f"inf {avg['inference']:.3f} / post {avg['postprocessing']:.3f}\n"
            f"Total per image: {total:.3f}s"
        )
        return summary


def _resize_map(pred: np.ndarray, output_size) -> np.ndarray:
    return resize_bilinear(torch.from_numpy(pred), tuple(output_size)).numpy()


class Predictor:
    """``model``: an already-built SPEGNet to use instead of loading
    ``model_path`` (it is moved to ``device`` and cast for compute).
    ``dir_manager`` None keeps results in memory: :meth:`predict_arrays`
    only, no output tree.  ``device`` None is the card (raises without
    one); pass "cpu" to run on the CPU."""

    def __init__(self, model_path: Optional[str], model_config: Dict, dir_manager,
                 batch_size: int = 1, device: Optional[str] = None,
                 model: Optional[SPEGNet] = None):
        self.batch_size = batch_size or 1
        self.device = resolve_device(device)
        img_cfg = model_config.get("image_processing", {})
        self.target_size = img_cfg.get("target_size", 512)
        self.processor = ImageProcessor(
            self.target_size,
            tuple(img_cfg.get("normalize_mean", (0.485, 0.456, 0.406))),
            tuple(img_cfg.get("normalize_std", (0.229, 0.224, 0.225))),
        )
        if model is None:
            model = SPEGNet(SPEGNetConfig.from_dict(model_config))
            state_dict, _ = load_checkpoint(model_path)
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().to_compute(self.device)
        self.result_manager = None
        if dir_manager is not None:
            self.result_manager = PredictionResultManager(dir_manager)
            self.result_manager.log_message(f"Model loaded from: {model_path or 'memory'}")

    @torch.inference_mode()
    def forward(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Normalized f32 [B, S, S, 3] -> (mask [B, S, S], edge [B, S/8, S/8])
        probabilities."""
        out = self.model(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        seg = torch.sigmoid(out["predictions"][-1].float())[..., 0]
        edge = torch.sigmoid(out["edge"].float())[..., 0]
        return seg.cpu().numpy(), edge.cpu().numpy()

    def predict_arrays(self, rgb: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Already-decoded u8 [H, W, 3] images -> (masks, edges), in batches
        of ``batch_size``."""
        segs, edges = [], []
        for i in range(0, len(rgb), self.batch_size):
            images = np.stack([self.processor.process_array(a)
                               for a in rgb[i: i + self.batch_size]])
            s, e = self.forward(images)
            segs.append(s)
            edges.append(e)
        return np.concatenate(segs), np.concatenate(edges)

    def predict_single(self, image_path: str,
                       output_size: Optional[Tuple[int, int]] = None):
        t0 = time.time()
        image = self.processor.process_image(image_path)[None]
        self.result_manager.update_timing("preprocessing", time.time() - t0)
        t0 = time.time()
        seg, edge = self.forward(image)
        seg, edge = seg[0], edge[0]
        dt = time.time() - t0
        self.result_manager.update_timing("inference", dt)
        self.result_manager.log_message(f"Inference time for {image_path}: {dt:.3f}s")
        t0 = time.time()
        if output_size:
            seg, edge = _resize_map(seg, output_size), _resize_map(edge, output_size)
        self.result_manager.update_timing("postprocessing", time.time() - t0)
        return seg, edge, self.processor.load_original(image_path)

    def predict_batch(self, image_paths: List[str],
                      output_size: Optional[Tuple[int, int]] = None,
                      num_workers: int = 4) -> Dict:
        """One forward per ``batch_size`` chunk; decoding and PNG writes run
        in a thread pool."""
        self.result_manager.log_message(
            f"Starting batch prediction of {len(image_paths)} images "
            f"with batch size {self.batch_size}")
        saves = []
        with ThreadPoolExecutor(max(num_workers, 1)) as pool:
            for i in range(0, len(image_paths), self.batch_size):
                chunk = image_paths[i: i + self.batch_size]
                t0 = time.time()
                loaded = list(pool.map(lambda p: (self.processor.process_image(p),
                                                  self.processor.load_original(p)), chunk))
                images = np.stack([im for im, _ in loaded]).astype(np.float32)
                self.result_manager.update_timing("preprocessing", time.time() - t0)
                t0 = time.time()
                seg, edge = self.forward(images)
                self.result_manager.update_timing("inference", time.time() - t0)
                t0 = time.time()
                for j, path in enumerate(chunk):
                    s, e = seg[j], edge[j]
                    if output_size:
                        s, e = _resize_map(s, output_size), _resize_map(e, output_size)
                    saves.append(pool.submit(self.result_manager.save_prediction,
                                             Path(path).name, s, e, loaded[j][1]))
                self.result_manager.update_timing("postprocessing", time.time() - t0)
            for f in saves:
                f.result()
        return self.result_manager.summarize()

    def predict_directory(self, input_dir: str,
                          output_size: Optional[Tuple[int, int]] = None,
                          extensions: tuple = (".jpg", ".png", ".jpeg")) -> Dict:
        input_dir = Path(input_dir)
        if not input_dir.is_dir():
            raise NotADirectoryError(f"Invalid directory: {input_dir}")
        image_paths = sorted(
            str(p) for p in input_dir.glob("**/*") if p.suffix.lower() in extensions)
        if not image_paths:
            raise ValueError(f"No valid images found in {input_dir}")
        self.result_manager.log_message(f"Found {len(image_paths)} images in {input_dir}")
        return self.predict_batch(image_paths, output_size)
