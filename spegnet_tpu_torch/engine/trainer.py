"""Training engine (port of spegnet_tpu/engine/trainer.py).

One eager train step on the device: u8 images normalized on the device,
the forward in train mode (batch-statistics BatchNorm, f32 master weights
cast to the compute dtype at use), the canvas loss (losses.cod_loss, f32),
the backward (the Hopper kernels' backward for the trunk blocks), the
global-norm clip and three AdamW groups.  Behaviour as the JAX trainer's:

* parameter groups: the encoder at lr x encoder_lr_ratio and weight decay
  0; the decoder's BatchNorm parameters at weight decay 0; the rest at the
  configured weight decay; betas (0.9, 0.999), eps 1e-8;
* the clip scales every gradient by max_norm / max(norm, max_norm) (optax's
  clip_by_global_norm, without clip_grad_norm_'s + 1e-6);
* ReduceLROnPlateau(mode=max, rel threshold 1e-4) as per-group lr scales
  (:class:`PlateauScheduler`);
* metrics.json with the reference's schema; checkpoints are ``.pth`` files
  holding model, optimizer and scheduler state, epoch, metrics and config,
  and resume starts at the next epoch.

Validation (and with it the plateau step and best-model selection) needs
the COD metrics, which are not ported yet: a config with ``val_ratio > 0``
is refused.  ``dir_manager=None`` keeps metrics and checkpoints in memory.
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from spegnet_tpu_torch.data.dataset import concat_train_datasets, train_val_split
from spegnet_tpu_torch.data.pipeline import ImageProcessor, TrainBatch, train_loader
from spegnet_tpu_torch.losses import LossConfig, cod_loss
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.utils.device import resolve_device
from spegnet_tpu_torch.utils.weights import init_weights

logger = logging.getLogger(__name__)

GROUPS = ("encoder", "decoder", "decoder_norm")


def param_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> optimizer group.  The JAX package labels by flax
    path (``_param_label``: "encoder" subtree, else any path key containing
    "norm" or "bn"); a torch name does not carry that (``context.reduce.1``
    is a BatchNorm), so the label here comes from the owning module's type."""
    labels = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if name.startswith("encoder."):
                labels[name] = "encoder"
            elif isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
                labels[name] = "decoder_norm"
            else:
                labels[name] = "decoder"
    return labels


class PlateauScheduler:
    """torch ReduceLROnPlateau (mode='max', rel threshold 1e-4), kept as
    per-group multiplicative lr scales."""

    def __init__(self, base_lrs: Dict[str, float], factor: float, patience: int,
                 min_lr: float, threshold: float = 1e-4):
        self.base_lrs = dict(base_lrs)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = -float("inf")
        self.num_bad_epochs = 0
        self.scales = {g: 1.0 for g in base_lrs}

    def step(self, metric: float) -> bool:
        if metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
            return False
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            for g, base in self.base_lrs.items():
                new_lr = max(self.scales[g] * base * self.factor, self.min_lr)
                self.scales[g] = new_lr / base
            self.num_bad_epochs = 0
            logger.info(f"Plateau: reducing LRs to "
                        f"{ {g: self.scales[g] * b for g, b in self.base_lrs.items()} }")
            return True
        return False

    def lrs(self) -> Dict[str, float]:
        return {g: self.scales[g] * b for g, b in self.base_lrs.items()}

    def state_dict(self) -> Dict[str, Any]:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "scales": dict(self.scales)}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.scales = dict(d["scales"])


class TrainingMonitor:
    """Metric history and best tracking, metrics.json in the reference's
    schema (in memory only when there is no run directory)."""

    def __init__(self, dir_manager=None):
        rd = dir_manager.run_dirs if dir_manager is not None else None
        self.metrics_file: Optional[Path] = rd.metrics_file if rd else None
        self.checkpoint_dir: Optional[Path] = rd.checkpoints if rd else None
        self.batch_stats = defaultdict(lambda: {"sum": 0.0, "count": 0})
        self.epoch_start = None
        self.history = {"epochs": [],
                        "best_metrics": {"weighted_f": 0.0, "s_alpha": 0.0,
                                         "mae": float("inf")}}
        if self.metrics_file is not None and self.metrics_file.exists():
            with open(self.metrics_file) as f:
                self.history = json.load(f)

    def start_epoch(self):
        self.batch_stats.clear()
        self.epoch_start = time.time()

    def update_batch(self, metrics: Dict[str, float], timing: Dict[str, float],
                     batch_size: int):
        for key, value in {**metrics, **timing}.items():
            self.batch_stats[key]["sum"] += float(value) * batch_size
            self.batch_stats[key]["count"] += batch_size

    def get_current_stats(self) -> Dict[str, float]:
        return {k: s["sum"] / s["count"] for k, s in self.batch_stats.items() if s["count"]}

    def save_history(self):
        if self.metrics_file is None:
            return
        tmp = self.metrics_file.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=2)
        tmp.rename(self.metrics_file)

    def save_epoch(self, epoch: int, phase: str):
        stats = self.get_current_stats()
        metrics = {k: v for k, v in stats.items() if not k.endswith("_time")}
        timing = {k: v for k, v in stats.items() if k.endswith("_time")}
        timing["epoch_time"] = time.time() - self.epoch_start
        while len(self.history["epochs"]) <= epoch:
            self.history["epochs"].append({"epoch": len(self.history["epochs"])})
        self.history["epochs"][epoch][phase] = {"metrics": metrics, "timing": timing}
        self.save_history()
        logger.info(f"Epoch {epoch} ({phase}) - Loss: {stats.get('loss', 0):.4f}, "
                    f"Time: {timing['epoch_time']:.2f}s")


def _sam2_trunk(path: str) -> Dict[str, torch.Tensor]:
    """``image_encoder.trunk.*`` of a SAM2 checkpoint under the port's
    ``encoder.encoder.*`` names (the same Hiera parameter names)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    pre = "image_encoder.trunk."
    out = {"encoder.encoder." + k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    if not out:
        raise ValueError(f"No image_encoder.trunk.* keys in {path}")
    return out


class Trainer:
    """``model``: an already-built SPEGNet (else one is built from the
    config with seeded random weights, plus the SAM2 trunk when the
    config's encoder checkpoint exists).  ``device`` None is the card
    (raises without one); pass "cpu" to train on the CPU."""

    def __init__(self, config: Dict, dir_manager=None, device: Optional[str] = None,
                 model: Optional[SPEGNet] = None):
        self.config = config["training"]
        self.model_config = config["model"]
        if self.config.get("val_ratio", 0.1) > 0:
            raise NotImplementedError(
                "validation needs the COD metrics (spegnet_tpu/metrics/jax_metrics.py), "
                "which the PyTorch port does not have yet; set training.val_ratio: 0")
        self.device = resolve_device(device)
        if model is None:
            model = init_weights(SPEGNet(SPEGNetConfig.from_dict(self.model_config)),
                                 torch.Generator().manual_seed(0))
            ckpt = self.model_config.get("encoder", {}).get("checkpoint_path")
            if ckpt and Path(ckpt).exists():
                res = model.load_state_dict(_sam2_trunk(ckpt), strict=False)
                missing = [k for k in res.missing_keys if k.startswith("encoder.encoder.")]
                if res.unexpected_keys or missing:
                    raise ValueError(f"SAM2 trunk keys of {ckpt} do not match the encoder: "
                                     f"unexpected {res.unexpected_keys[:5]}, "
                                     f"missing {missing[:5]}")
                logger.info(f"Loaded pretrained encoder from {ckpt}")
            elif ckpt:
                logger.warning(f"Encoder checkpoint {ckpt} not found - training from scratch")
        self.model = model.to(self.device)
        self.loss_cfg = LossConfig.from_dict(self.config.get("loss", {}))
        self.batch_size = self.config["batch_size"]
        self.num_epochs = self.config["num_epochs"]
        self.grad_clip = self.config.get("gradient_clip", 1.0)
        self.save_freq = self.config.get("save_freq", 20)
        self.buckets = tuple(self.config.get("canvas_buckets", (512, 1024, 2048)))
        img_cfg = self.model_config.get("image_processing", {})
        self.processor = ImageProcessor(
            img_cfg.get("target_size", 512),
            tuple(img_cfg.get("normalize_mean", (0.485, 0.456, 0.406))),
            tuple(img_cfg.get("normalize_std", (0.229, 0.224, 0.225))))
        self.mean = torch.as_tensor(self.processor.mean, device=self.device)
        self.std = torch.as_tensor(self.processor.std, device=self.device)
        self.monitor = TrainingMonitor(dir_manager)
        self._init_optimizer()

    def _init_optimizer(self):
        opt = self.config.get("optimizer", {})
        base_lr = opt.get("learning_rate", 1e-4)
        wd = opt.get("weight_decay", 1e-5)
        enc_ratio = opt.get("encoder_lr_ratio", 0.05)
        labels = param_labels(self.model)
        params = dict(self.model.named_parameters())
        base_lrs = {"encoder": base_lr * enc_ratio, "decoder": base_lr,
                    "decoder_norm": base_lr}
        wd_map = {"encoder": 0.0, "decoder": wd, "decoder_norm": 0.0}
        groups = [{"params": [params[n] for n in labels if labels[n] == g], "name": g,
                   "lr": base_lrs[g], "weight_decay": wd_map[g]} for g in GROUPS]
        self.optimizer = torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
        sch = self.config.get("scheduler", {})
        self.scheduler = PlateauScheduler(base_lrs, factor=sch.get("factor", 0.7),
                                          patience=sch.get("patience", 5),
                                          min_lr=sch.get("min_lr", 1e-6))
        self.start_epoch = 0

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _prep(self, images: torch.Tensor) -> torch.Tensor:
        """u8 wire -> (x / 255 - mean) / std in f32 on the device; float
        images are taken as already normalized."""
        if images.dtype == torch.uint8:
            return (images.to(torch.float32) / 255.0 - self.mean) / self.std
        return wide(images)

    def to_device(self, batch: TrainBatch) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)
                for a in (batch.images, batch.masks, batch.edges, batch.mask_hw,
                          batch.edge_hw)]

    def forward_loss(self, images, masks, edges, mask_hw, edge_hw) -> Dict[str, torch.Tensor]:
        """The forward in train mode and the loss (device tensors)."""
        self.model.train()
        out = self.model(self._prep(images))
        return cod_loss(out["predictions"], out["edge"], masks, edges, mask_hw, edge_hw,
                        self.loss_cfg)

    def clip_and_step(self) -> None:
        """Global-norm clip (optax's formula) and the AdamW step at the
        groups' current lr scales."""
        grads = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        if self.grad_clip and self.grad_clip > 0 and grads:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        lrs = self.scheduler.lrs()
        for group in self.optimizer.param_groups:
            group["lr"] = lrs[group["name"]]
        self.optimizer.step()

    def train_step(self, batch: TrainBatch) -> Dict[str, Dict[str, float]]:
        """One step on a host batch -> {"metrics": losses, "timing": seconds}.
        The forward (+ loss) and backward (+ clip and optimizer) times are
        CUDA-event times on the card, host clock times on the CPU."""
        t0 = time.perf_counter()
        dev = self.to_device(batch)
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        t1 = time.perf_counter()
        ld = self.forward_loss(*dev)
        if cuda:
            ev[1].record()
        t2 = time.perf_counter()
        self.optimizer.zero_grad(set_to_none=True)
        ld["loss"].backward()
        self.clip_and_step()
        metrics = {k: float(v.detach()) for k, v in ld.items()}
        t3 = time.perf_counter()
        if cuda:
            ev[2].record()
            ev[2].synchronize()
            fwd, bwd = ev[0].elapsed_time(ev[1]) / 1e3, ev[1].elapsed_time(ev[2]) / 1e3
        else:
            fwd, bwd = t2 - t1, t3 - t2
        timing = {"data_time": t1 - t0, "forward_time": fwd, "backward_time": bwd,
                  "batch_time": time.perf_counter() - t0}
        return {"metrics": metrics, "timing": timing}

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_epoch(self, loader, epoch: int) -> Dict[str, float]:
        self.monitor.start_epoch()
        for i, batch in enumerate(loader):
            res = self.train_step(batch)
            self.monitor.update_batch(res["metrics"], res["timing"], batch.images.shape[0])
            if i % 10 == 0:
                m = res["metrics"]
                logger.info(f"Epoch {epoch + 1}/{self.num_epochs} step {i}: "
                            f"loss={m['loss']:.4f} seg={m['seg_loss']:.4f} "
                            f"edge={m['edge_loss']:.4f} ({res['timing']['batch_time']:.2f}s)")
        return self.monitor.get_current_stats()

    def train(self, dataset_dirs: List[str]):
        try:
            self._train(dataset_dirs)
        except Exception as e:
            logger.error(f"Training error: {e}", exc_info=True)
            raise

    def _train(self, dataset_dirs: List[str]):
        dataset = concat_train_datasets(dataset_dirs)
        train_ds, _ = train_val_split(dataset, self.config.get("val_ratio", 0.1))
        logger.info(f"Training samples: {len(train_ds)}")
        bf16 = self.model.config.dtype == torch.bfloat16
        wire_u8 = self.config.get("image_wire", "u8" if bf16 else "f32") == "u8"
        for epoch in range(self.start_epoch, self.num_epochs):
            loader = train_loader(train_ds, self.processor, self.batch_size, self.buckets,
                                  shuffle=True, seed=epoch,
                                  num_workers=self.config.get("num_workers", 4),
                                  image_u8=wire_u8)
            self.train_epoch(loader, epoch)
            self.monitor.save_epoch(epoch, "train")
            if (epoch + 1) % self.save_freq == 0:
                self.save_checkpoint(epoch, self.monitor.get_current_stats(), is_best=False)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def checkpoint_state(self, epoch: int, metrics: Dict[str, float]) -> Dict[str, Any]:
        return {"model_state_dict": self.model.state_dict(),
                "optimizer_state_dict": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "epoch": epoch,
                "metrics": {k: float(v) for k, v in (metrics or {}).items()},
                "config": {"training": self.config, "model": self.model_config}}

    def save_checkpoint(self, epoch: int, metrics: Dict[str, float],
                        is_best: bool) -> Optional[Path]:
        """model_best.pth / checkpoint_{epoch:03d}.pth in the run's checkpoint
        directory (None without one)."""
        if self.monitor.checkpoint_dir is None:
            return None
        name = "model_best.pth" if is_best else f"checkpoint_{epoch:03d}.pth"
        path = self.monitor.checkpoint_dir / name
        tmp = path.with_suffix(".tmp")
        torch.save(self.checkpoint_state(epoch, metrics), tmp)
        tmp.rename(path)
        logger.info(f"Saved checkpoint: {path}")
        return path

    def load_checkpoint(self, path: str, resume: bool = True) -> None:
        """Model weights, and with ``resume`` the optimizer, scheduler and
        epoch (training continues at the next epoch)."""
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
        self.model.load_state_dict(ckpt["model_state_dict"])
        if resume:
            self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
            self.scheduler.load_state_dict(ckpt["scheduler"])
            self.start_epoch = ckpt["epoch"] + 1
            logger.info(f"Resumed from {path} at epoch {self.start_epoch}")
