"""Evaluation engine (port of spegnet_tpu/engine/evaluator.py).

One device step per batch: the forward, each sample's final logits resized
to its ground truth's size inside the canvas, uint8 quantization and the
five COD metrics (metrics/torch_metrics.py), all on ``device``; only the
[B] metric rows cross to the host unless visualizations are written.

The output tree is the JAX package's (and the reference's): per dataset,
quality buckets good / medium / bad at 0.8 / 0.6 on both S_alpha and
F_beta^w, ``{dataset}/metrics/{bucket}/{name}_metrics.json``, optional
``{dataset}/visualizations/{bucket}/{segmentation,edges}/{binary,heatmap,
overlay}/`` PNGs, and ``{dataset}/evaluation_summary.json`` with the
dataset means, the timing (CUDA events around the forward and the metrics
on the card) and the bucket counts.  ``dir_manager=None`` keeps everything
in memory (:attr:`Evaluator.sample_metrics`, :attr:`Evaluator.summaries`).

Under data parallelism (``mesh``, parallel/mesh.py; JAX's ``Evaluator``
with a mesh, :121-146) ``batch_size`` is rounded up to a multiple of the
data axis, each data index runs its rows of every batch (decoding only
those; padding rows carry no weight) and writes their per-sample files, and
the per-sample metrics are gathered in dataset order, from which rank 0
writes the summaries (every rank returns the same means).  Under a spatial
axis (``model.spatial_axis``) the ranks of a spatial group run the same
rows, splitting the trunk's tokens (models/hiera.py) and the head's rows
(models/spegnet.py; every rank holds the whole outputs); under a model axis
the ranks of a model group run the same rows on the full weights, as
JAX's evaluator places its variables replicated (:143-146); under both
the S M ranks of a data index run its rows on the full weights, splitting
the trunk's tokens over their spatial groups.  The rank of spatial and
model index 0 of a data index (``Mesh.lead``) writes the files and gives
the records.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from spegnet_tpu_torch.config import DEFAULT_CANVAS_BUCKETS
from spegnet_tpu_torch.data.dataset import CODDataset
from spegnet_tpu_torch.data.pipeline import EvalBatch, ImageProcessor, eval_loader
from spegnet_tpu_torch.engine.model_loader import load_checkpoint
from spegnet_tpu_torch.losses import resize_logits_to_canvas
from spegnet_tpu_torch.metrics.torch_metrics import compute_batch_metrics, quantize_predictions
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.parallel.mesh import Mesh, create_mesh, require_group
from spegnet_tpu_torch.utils.device import f32_precision, resolve_device

logger = logging.getLogger(__name__)

METRIC_KEYS = ("s_alpha", "weighted_f", "mae", "e_phi", "mean_f")
_DEVICE_TO_API = {"sm": "s_alpha", "wfm": "weighted_f", "mae": "mae", "em": "e_phi",
                  "fm": "mean_f"}


class ResultManager:
    """Quality-bucketed storage of per-sample results."""

    def __init__(self, dir_manager):
        self.run_dirs = dir_manager.run_dirs
        self.dataset_dirs: Dict[str, Dict[str, Path]] = {}

    def setup_dataset_directories(self, dataset_name: str):
        root = self.run_dirs.root / dataset_name
        viz, metrics = root / "visualizations", root / "metrics"
        for cat in ("good", "medium", "bad"):
            (viz / cat / "segmentation").mkdir(parents=True, exist_ok=True)
            (viz / cat / "edges").mkdir(parents=True, exist_ok=True)
            (metrics / cat).mkdir(parents=True, exist_ok=True)
        self.dataset_dirs[dataset_name] = {"root": root, "visualizations": viz,
                                           "metrics": metrics}

    @staticmethod
    def determine_quality_category(metrics: Dict[str, float]) -> str:
        s, f = metrics["s_alpha"], metrics["weighted_f"]
        if s >= 0.8 and f >= 0.8:
            return "good"
        if s >= 0.6 and f >= 0.6:
            return "medium"
        return "bad"

    def save_metrics(self, dataset_name: str, filename: str, metrics: Dict[str, float]) -> str:
        """Write {name}_metrics.json in the sample's bucket; returns the bucket."""
        category = self.determine_quality_category(metrics)
        path = self.dataset_dirs[dataset_name]["metrics"] / category / f"{filename}_metrics.json"
        try:
            with open(path, "w") as f:
                json.dump(metrics, f, indent=4)
        except Exception as e:  # one image's failure does not stop the run
            logger.error(f"Failed to save metrics {filename}: {e}")
        return category

    def save_prediction(self, dataset_name: str, filename: str, metrics: Dict[str, float],
                        seg_pred: np.ndarray, edge_pred: np.ndarray, stage_preds,
                        original_image: Optional[np.ndarray]) -> str:
        """binary / heatmap (/ overlay) PNGs of the mask (and of each stage's
        mask) and of the edge map, then the metrics JSON."""
        from spegnet_tpu_torch.utils.visualization import (
            save_binary_visualization,
            save_heatmap_visualization,
            save_overlay_visualization,
        )

        category = self.determine_quality_category(metrics)
        viz = self.dataset_dirs[dataset_name]["visualizations"] / category
        try:
            for kind, pred, stages in (("segmentation", seg_pred, stage_preds),
                                       ("edges", edge_pred, None)):
                base = viz / kind
                save_binary_visualization(pred, base / "binary" / f"{filename}.png")
                save_heatmap_visualization(pred, base / "heatmap" / f"{filename}.png")
                if original_image is not None:
                    save_overlay_visualization(original_image, pred,
                                               base / "overlay" / f"{filename}.png", alpha=0.7)
                for i, sp in enumerate(stages or ()):
                    name = f"{filename}_stage{i + 1}.png"
                    save_binary_visualization(sp, base / "binary" / name)
                    save_heatmap_visualization(sp, base / "heatmap" / name)
        except Exception as e:  # one image's failure does not stop the run
            logger.error(f"Failed to save prediction {filename}: {e}")
        return self.save_metrics(dataset_name, filename, metrics)


class Evaluator:
    """``model``: an already-built SPEGNet to use instead of loading
    ``model_path``.  ``device`` None is the card (raises without one); pass
    "cpu" to run on the CPU.  ``mesh``: the data-parallel (and spatial) mesh
    (default: one data axis over the processes of the active group); the
    model takes its spatial group from it."""

    def __init__(self, model_path: Optional[str], dir_manager, model_config: Dict,
                 batch_size: int, save_visualizations: bool = True,
                 canvas_buckets=DEFAULT_CANVAS_BUCKETS, device: Optional[str] = None,
                 model: Optional[SPEGNet] = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        mesh = mesh or create_mesh()
        require_group(mesh)
        self.mesh = mesh
        self.shard = (mesh.data_index, mesh.data)
        self.batch_size = -(-batch_size // mesh.data) * mesh.data
        if self.batch_size != batch_size:
            logger.info(f"Eval batch size rounded up to {self.batch_size} "
                        f"(multiple of data axis {mesh.data})")
        self.buckets = tuple(canvas_buckets)
        if model is None:
            model = SPEGNet(SPEGNetConfig.from_dict(model_config))
            state_dict, _ = load_checkpoint(model_path)
            model.load_state_dict(state_dict, strict=True)
        self.model = sharding.replicated(model.eval().to_compute(self.device))
        self.model.shard_tokens(mesh.token_shard)
        f32_precision(model.config.dtype)
        img_cfg = model_config.get("image_processing", {})
        self.target_size = img_cfg.get("target_size", 512)
        self.processor = ImageProcessor(
            self.target_size,
            tuple(img_cfg.get("normalize_mean", (0.485, 0.456, 0.406))),
            tuple(img_cfg.get("normalize_std", (0.229, 0.224, 0.225))))
        self.result_manager = ResultManager(dir_manager) if dir_manager is not None else None
        self.save_visualizations = save_visualizations and self.result_manager is not None
        self.sample_metrics: Dict[str, Dict[str, Dict[str, float]]] = {}
        self.summaries: Dict[str, Dict] = {}
        logger.info(f"Model loaded from: {model_path or 'memory'}")
        self._warmup()

    # -- device step -------------------------------------------------------
    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.device.type == "cuda" else (b - a) * 1e3

    @torch.inference_mode()
    def step(self, batch: EvalBatch):
        """One batch -> (metric rows {device key: [B] numpy}, and with
        visualizations the masks, edge maps and stage masks as numpy, else
        None x 3; the forward's and the metrics' ms)."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        images, masks, hw, dst, idx = (put(a) for a in (
            batch.images, batch.masks, batch.mask_hw, batch.dst, batch.nearest_idx))
        canvas = tuple(masks.shape[1:3])
        t0 = self._mark()
        out = self.model(images)
        t1 = self._mark()
        pred_c, valid = resize_logits_to_canvas(out["predictions"][-1].float(), hw, canvas)
        seg = compute_batch_metrics(quantize_predictions(pred_c), masks, valid, hw, dst, idx)
        t2 = self._mark()
        seg = {k: v.cpu().numpy() for k, v in seg.items()}
        timing = (self._ms(t0, t1), self._ms(t1, t2))
        if not self.save_visualizations:
            return seg, None, None, None, timing
        edge_c, _ = resize_logits_to_canvas(out["edge"].float(), hw, canvas)
        stages = [torch.sigmoid(p.float())[..., 0].cpu().numpy() for p in out["predictions"]]
        return (seg, torch.sigmoid(pred_c).cpu().numpy(), torch.sigmoid(edge_c).cpu().numpy(),
                stages, timing)

    def _warmup(self):
        """One pass on a zero batch at the target canvas: builds the kernels
        (and packs the int8 weights) before anything is timed."""
        s, b = self.target_size, self.batch_size // self.shard[1]
        self.step(EvalBatch(np.zeros((b, s, s, 3), np.float32), np.zeros((b, s, s), np.float32),
                            np.full((b, 2), s, np.int32), np.zeros((b, s, s), np.float32),
                            np.zeros((b, s, s), np.int32), np.zeros((b,), np.float32),
                            [""] * b))

    def _denormalize(self, image: np.ndarray) -> np.ndarray:
        img = image * self.processor.std + self.processor.mean
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    # -- datasets ----------------------------------------------------------
    def evaluate(self, dataset: Optional[CODDataset], dataset_name: str,
                 loader: Optional[Iterable[EvalBatch]] = None) -> Dict[str, float]:
        """Mean metrics of a dataset (or of the batches of ``loader``, whole
        batches of ``batch_size`` rows of which each rank takes its own)."""
        if self.result_manager is not None:
            self.result_manager.setup_dataset_directories(dataset_name)
        timing = {"inference_times": [], "processing_times": [], "forward_ms": [],
                  "metrics_ms": []}
        records = []   # (dataset index, (name, metrics)) of this rank's samples
        start = time.time()
        rank, ranks = self.shard
        writes = self.mesh.lead
        whole = loader is not None
        if loader is None:
            loader = eval_loader(dataset, self.processor, self.batch_size, self.buckets,
                                 with_originals=self.save_visualizations, shard=self.shard)
        for step, batch in enumerate(loader):
            if whole and ranks > 1:
                batch = sharding.shard_batch(batch, rank, ranks)
            first = step * self.batch_size + rank * batch.images.shape[0]
            t_batch = time.time()
            seg, pred_c, edge_c, stages, (f_ms, m_ms) = self.step(batch)
            timing["inference_times"].append(time.time() - t_batch)
            timing["forward_ms"].append(f_ms)
            timing["metrics_ms"].append(m_ms)
            for i in range(batch.images.shape[0] if writes else 0):
                if batch.sample_mask[i] == 0:
                    continue
                metrics = {_DEVICE_TO_API[k]: float(seg[k][i]) for k in seg}
                records.append((first + i, (batch.names[i], metrics)))
                if self.save_visualizations:
                    h, w = batch.mask_hw[i]
                    orig = (batch.originals[i] if batch.originals
                            else self._denormalize(batch.images[i]))
                    self.result_manager.save_prediction(
                        dataset_name, batch.names[i], metrics, pred_c[i, :h, :w],
                        edge_c[i, :h, :w], [s[i] for s in stages], orig)
                elif self.result_manager is not None:
                    self.result_manager.save_metrics(dataset_name, batch.names[i], metrics)
            timing["processing_times"].append(time.time() - t_batch)
        totals = {k: 0.0 for k in METRIC_KEYS}
        counts = {"good": 0, "medium": 0, "bad": 0}
        per_sample = self.sample_metrics.setdefault(dataset_name, {})
        samples = sharding.gather_in_order(records)
        for name, metrics in samples:
            for k in METRIC_KEYS:
                totals[k] += metrics[k]
            per_sample[name] = metrics
            counts[ResultManager.determine_quality_category(metrics)] += 1
        n_samples = len(samples)
        avg = {k: v / max(n_samples, 1) for k, v in totals.items()}
        self._save_summary(dataset_name, avg, counts, timing, n_samples,
                           time.time() - start)
        return avg

    def _save_summary(self, dataset_name: str, metrics: Dict[str, float],
                      counts: Dict[str, int], timing: Dict, n_samples: int, total: float):
        def mean(v):
            return float(np.mean(v)) if v else 0.0

        t = {"total_time": total,
             "avg_inference_time": mean(timing["inference_times"]),
             "avg_processing_time": mean(timing["processing_times"]),
             "total_samples": n_samples,
             "device": str(self.device),
             "forward_ms": timing["forward_ms"],
             "metrics_ms": timing["metrics_ms"],
             "forward_ms_per_image": sum(timing["forward_ms"]) / max(n_samples, 1),
             "metrics_ms_per_image": sum(timing["metrics_ms"]) / max(n_samples, 1)}
        summary = {"metrics": metrics, "timing": t,
                   "categories": {"counts": dict(counts), "total": sum(counts.values())}}
        self.summaries[dataset_name] = summary
        if self.result_manager is not None and self.mesh.rank == 0:
            out = (self.result_manager.dataset_dirs[dataset_name]["root"]
                   / "evaluation_summary.json")
            with open(out, "w") as f:
                json.dump(summary, f, indent=4)
        logger.info(f"Evaluation results for {dataset_name}: {n_samples} samples in "
                    f"{total:.2f}s, forward {t['forward_ms_per_image']:.2f} ms/img, metrics "
                    f"{t['metrics_ms_per_image']:.2f} ms/img")
        for k in METRIC_KEYS:
            logger.info(f"{k}: {metrics[k]:.4f}")
