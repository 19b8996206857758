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
  and resume starts at the next epoch;
* with ``val_ratio > 0``, validation after every epoch on the held-out
  split: an eval-mode forward (running BatchNorm statistics, the predict
  path's kernels, the int8 routes where the config asks for them), the
  loss and the five COD metrics of the masks and the edge MAE / mean F
  (metrics/torch_metrics.py) on the device; the plateau step on the
  weighted F-measure, ``model_best.pth`` when it improves by more than
  ``min_delta``, and the early stop after ``early_stop_patience`` epochs
  without that.

``dir_manager=None`` keeps metrics and checkpoints in memory.

Data parallelism (the config's ``parallel.mesh``, parallel/mesh.py; the
JAX trainer's ``data`` axis): in a torch.distributed group the model runs
under DistributedDataParallel (``find_unused_parameters=False``: a parameter
that gets no gradient is named and refused), each rank on its rows of each
global batch (the loaders' ``shard``; a whole batch given to
:meth:`Trainer.train_step` is padded and sharded here, as JAX's
``_put_train_batch``).  The tail batch is padded to a multiple of the ranks
with zero-weight rows (parallel/sharding.pad_batch); each rank's loss is
its rows' sum(w l) / W over the global batch's weight W, scaled by the
ranks to undo DDP's average, so the summed gradient is that of JAX's global
weighted mean; BatchNorm takes the global batch's statistics
(models/cfi.BatchNorm2d).  The clip stays local (every rank holds the same
reduced gradients).  Validation is sharded and padded the same way and its
per-sample metrics gathered in dataset order, so the plateau step, the best
model and the early stop are one decision on every rank.  Rank 0 alone
writes metrics.json and checkpoints; a resume loads on every rank.

Sequence parallelism (``model.spatial_axis`` naming a ``parallel.mesh``
axis of size S beside ``data`` of size D, over D S processes; JAX's
``spatial_axis``): the S ranks of a spatial group take the rows of their
data index and split the Morton trunk's tokens (models/hiera.py
``trunk_plan``); the K / V of a global block and the trunk's outputs are
all-gathered over the group, and the head after the trunk runs on each
rank's band of rows, its outputs gathered along H (models/spegnet.py;
whole on each rank where models/hiera.head_bands refuses).  The gradient
rule is the one of all three axes below (M = 1: DDP averages over all D S
ranks and the loss is scaled by D).

Tensor parallelism (``parallel.mesh: {data: D, model: M}`` over D M
processes; JAX's ``model`` axis, placed by its trainer's
``param_shardings``): the M ranks of a model group take the rows of their
data index and hold 1/M of the encoder's qkv, attention proj, fc1 and fc2
(``SPEGNet.shard_model``, parallel/sharding.param_spec); AdamW runs on the
shards, and the gradient rule is the one below (S = 1).  A replicated
parameter's gradient on a rank is its part (its heads' and hidden columns'
terms), and the parts are summed over the model group, so the replicated
parameters stay bit-equal across it.  The global-norm clip counts each
shard once (the shards' squares summed over the model group, the
replicated ones' taken once).  ``checkpoint_state`` gathers every parameter
and every AdamW moment into the reference schema (every rank of a model
group takes part; rank 0 writes), and :meth:`Trainer.load_checkpoint`
shards what it loads, so a checkpoint moves between M and one process
either way, with or without a spatial axis.

Both, ``parallel.mesh: {data: D, sp: S, model: M}`` with
``model.spatial_axis: sp`` over D S M processes: the S M ranks of one data
index take its rows; the S ranks of a spatial group split the trunk's
tokens and the M ranks of a model group split the four matmuls.  The
gradient rule, derived for all three axes at once (S = 1 or M = 1 is
either axis alone, S = M = 1 plain data parallelism).  Let L_d be data
index d's share of the global batch's weighted mean loss (losses.cod_loss
with W summed over the data group), so the objective is sum_d L_d.  Every
rank of data index d computes L_d, and every collective is differentiated
as the global program whose objective is the sum of all D S M ranks'
losses, S M sum_d L_d: an all-gather's and an all-reduce's backward both
sum the cotangents over the ranks they joined.  Each parameter is held by
several ranks -- a shard of model index m by the D S ranks of that index, a
replicated parameter by all D S M -- and each rank's gradient is the global
program's for its own copy (a shard's copy reaches the M ranks of its model
group through the weight gather; the token rows of a sharded block reach
the S ranks of its spatial group through the stage outputs' gather; a
head parameter's copy on rank s of a spatial group, under row bands, gets
the part of its band, S times over, through the outputs' row gather, whose
backward sums the S ranks' cotangents, and through the halos and means,
whose backward sends each cotangent to the rank that owns the row), so the
copies' gradients summed over their holders are the global program's for
the tied parameter: S M times its gradient G of sum_d L_d.  So the rule
takes the head's parameters as it did when each rank ran the head whole:
the copies now differ across a spatial group, and their sum is the same.
The step then:

* sums each replicated parameter's gradient over the model group
  (:meth:`Trainer._reduce_replicated`), so every rank holds the sum over
  its model group and the D S ranks of one model index hold, between them,
  the S M G of the sum over all holders;
* has DDP average over its group, the D S ranks of one model index
  (``Mesh.replica_group``; every rank without a model axis), so it never
  mixes two shards: a shard's S M G and a replicated parameter's S M G both
  become S M G / (D S);
* scales the loss by D / M before the backward, which makes that G.

The BatchNorm statistics (models/cfi.BatchNorm2d) sum x, x^2 and the count
over all D S M ranks, M copies of each band's pixels in each (S M of a
pooled 1x1 map's, and of a head that runs whole), so their ratios are the
global batch's, and the backward of that all-reduce is the global
program's like every other collective.  The sample weights W and the
reported losses, which need no gradient, are summed over the data group
(one rank per data index).  The T-blocks' weight gradients end up summed
over the D S ranks as JAX's ``psum(g, data + tok)`` sums them
(spegnet_tpu/ops/fused_block_t.py:1652-1658).  The f64 step on ``{1, 2,
2}`` and ``{2, 2, 2}`` against one process (tests/test_torch_sp_model.py)
is the rule's proof.

``training.remat`` (default: batch per rank > 16, JAX's rule) recomputes
the trunk's decomposed blocks in the backward (models/hiera.py), the global
blocks under sequence parallelism among them.  ``training.profile`` (or
``profile_dir``) traces steps 2-6 with torch.profiler into the run's
``profile/`` directory (utils/profiling.TraceSession); ``training.debug_nans``
raises on the first non-finite loss or gradient, naming the parameter.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from spegnet_tpu_torch.data.dataset import concat_train_datasets, train_val_split
from spegnet_tpu_torch.data.pipeline import (
    ImageProcessor,
    TrainBatch,
    ValBatch,
    train_loader,
    val_loader,
)
from spegnet_tpu_torch.losses import LossConfig, cod_loss, resize_logits_to_canvas
from spegnet_tpu_torch.metrics.torch_metrics import compute_batch_metrics, quantize_predictions
from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.parallel import sharding
from spegnet_tpu_torch.parallel.mesh import Mesh, grouped, mesh_from_config, require_group
from spegnet_tpu_torch.utils.device import f32_precision, resolve_device
from spegnet_tpu_torch.utils.profiling import TraceSession
from spegnet_tpu_torch.utils.weights import full_state_dict, init_weights, load_sharded

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

    def check_best_model(self, current: Dict[str, float]) -> bool:
        if current["weighted_f"] > self.history["best_metrics"]["weighted_f"]:
            self.history["best_metrics"] = dict(current)
            self.save_history()
            logger.info(f"New best model -> F-Measure: {current['weighted_f']:.4f}")
            return True
        return False

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
        if phase == "val":
            logger.info(f"Epoch {epoch} (val) - F-measure: {stats.get('weighted_f', 0):.4f}, "
                        f"S-alpha: {stats.get('s_alpha', 0):.4f}, "
                        f"MAE: {stats.get('mae', 0):.4f}, Loss: {stats.get('loss', 0):.4f}, "
                        f"Time: {timing['epoch_time']:.2f}s")
        else:
            logger.info(f"Epoch {epoch} ({phase}) - Loss: {stats.get('loss', 0):.4f}, "
                        f"Time: {timing['epoch_time']:.2f}s")


def remat_for(training: Dict, data_axis: int) -> bool:
    """``training.remat``, else whether the batch per rank exceeds 16 (the
    JAX trainer's rule, spegnet_tpu/engine/trainer.py:193-195)."""
    return bool(training.get("remat", -(-training["batch_size"] // data_axis) > 16))


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
    (raises without one); pass "cpu" to train on the CPU.  ``mesh``: the
    data-parallel mesh (default: the config's ``parallel.mesh`` over the
    processes of the active group); a data axis above 1 needs the group
    (parallel/mesh.init_distributed), as does a spatial or a model axis
    above 1, whose group the model is given (``model`` is sharded here)."""

    def __init__(self, config: Dict, dir_manager=None, device: Optional[str] = None,
                 model: Optional[SPEGNet] = None, mesh: Optional[Mesh] = None):
        self.config = config["training"]
        self.model_config = config["model"]
        self.mesh = mesh or mesh_from_config(config.get("parallel"),
                                             spatial_axis=self.model_config.get("spatial_axis"))
        require_group(self.mesh)
        # a spatial group's ranks take the same rows: those of their data index
        self.data_axis, self.data_index = self.mesh.data, self.mesh.data_index
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
        model.config = dataclasses.replace(model.config,
                                           remat=remat_for(self.config, self.data_axis))
        model.shard_model(self.mesh.model_shard)
        self.model = model.to(self.device).shard_tokens(self.mesh.token_shard)
        self.ddp = self.model
        if grouped():
            self.ddp = DistributedDataParallel(
                self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                find_unused_parameters=False, broadcast_buffers=False,
                process_group=self.mesh.replica_group)
        self._grads_checked = not grouped()
        f32_precision(model.config.dtype)
        self.loss_cfg = LossConfig.from_dict(self.config.get("loss", {}))
        self.batch_size = self.config["batch_size"]
        self.num_epochs = self.config["num_epochs"]
        self.grad_clip = self.config.get("gradient_clip", 1.0)
        self.save_freq = self.config.get("save_freq", 20)
        self.early_stop_patience = self.config.get("early_stop_patience", 20)
        self.min_delta = self.config.get("min_delta", 5e-4)
        self.buckets = tuple(self.config.get("canvas_buckets", (512, 1024, 2048)))
        img_cfg = self.model_config.get("image_processing", {})
        self.processor = ImageProcessor(
            img_cfg.get("target_size", 512),
            tuple(img_cfg.get("normalize_mean", (0.485, 0.456, 0.406))),
            tuple(img_cfg.get("normalize_std", (0.229, 0.224, 0.225))))
        self.mean = torch.as_tensor(self.processor.mean, device=self.device)
        self.std = torch.as_tensor(self.processor.std, device=self.device)
        self.monitor = TrainingMonitor(dir_manager if self.mesh.rank == 0 else None)
        profile_dir = self.config.get("profile_dir")
        if profile_dir is None and self.config.get("profile") and dir_manager is not None:
            profile_dir = str(dir_manager.run_dirs.root / "profile")
        self.trace = TraceSession(profile_dir, rank=self.mesh.rank if grouped() else None)
        self.debug_nans = bool(self.config.get("debug_nans", False))
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
        # the parameters' names in the optimizer's order (its state's indices)
        self.param_names = [n for g in GROUPS for n in labels if labels[n] == g]
        self.sharded = {n for n in self.param_names if sharding.shard_dim(n) is not None
                        and self.mesh.model > 1}
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
        """images, masks, edges, mask_hw, edge_hw (and a ValBatch's dst,
        nearest_idx) on the device."""
        arrays = [batch.images, batch.masks, batch.edges, batch.mask_hw, batch.edge_hw]
        if isinstance(batch, ValBatch):
            arrays += [batch.dst, batch.nearest_idx]
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)
                for a in arrays]

    def local_batch(self, batch: TrainBatch) -> TrainBatch:
        """This rank's rows of a whole batch (``sample_w`` None) under a data
        axis above 1: padded to a multiple of it, then sharded
        (parallel/sharding.py); a rank's share (a sharded loader's batch) or
        a batch of one process as it is."""
        if batch.sample_w is not None or self.data_axis == 1:
            return batch
        padded, w = sharding.pad_batch(batch, self.data_axis)
        padded.sample_w = w
        return sharding.shard_batch(padded, self.data_index, self.data_axis)

    def weights(self, batch: TrainBatch):
        """(the rows' sample weights on the device, the global batch's weight
        summed over the data group), or (None, None) for a batch of one
        process."""
        if batch.sample_w is None:
            return None, None
        w = torch.from_numpy(np.ascontiguousarray(batch.sample_w)).to(self.device)
        return w, sharding.all_reduce_sum(w.sum(), self.mesh.data_group)

    def forward_loss(self, images, masks, edges, mask_hw, edge_hw, sample_w=None,
                     weight_total=None) -> Dict[str, torch.Tensor]:
        """The forward in train mode (through DDP in a process group) and the
        loss (device tensors): the batch mean, or with ``sample_w`` this
        rank's share of the global batch's weighted mean (losses.cod_loss)."""
        self.model.train()
        out = self.ddp(self._prep(images))
        return cod_loss(out["predictions"], out["edge"], masks, edges, mask_hw, edge_hw,
                        self.loss_cfg, sample_w, weight_total)

    def _check_grads(self) -> None:
        """After the first backward under DDP: every parameter has a
        gradient (DDP runs with find_unused_parameters=False)."""
        if self._grads_checked:
            return
        missing = [n for n, p in self.model.named_parameters()
                   if p.requires_grad and p.grad is None]
        if missing:
            raise RuntimeError(f"{len(missing)} parameters got no gradient, which "
                               f"DistributedDataParallel cannot reduce: {missing[:8]}")
        self._grads_checked = True

    def _named_grads(self):
        """(name, gradient) of every parameter that has one, in the
        optimizer's order."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        return [(n, p.grad) for n, p in zip(self.param_names, params) if p.grad is not None]

    def _reduce_replicated(self) -> None:
        """Under the model axis: the replicated parameters' gradients summed
        over the model group (module docstring), in one all-reduce."""
        grads = [g for n, g in self._named_grads() if n not in self.sharded]
        flat = sharding.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                       self.mesh.model_group)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    def _global_norm(self, named) -> torch.Tensor:
        """The gradients' global norm; under the model axis each shard
        counted once: the shards' squares summed over the model group."""
        norms = torch.stack([torch.linalg.vector_norm(g) for _, g in named])
        if not self.sharded:
            return torch.linalg.vector_norm(norms)
        split = torch.tensor([n in self.sharded for n, _ in named], device=norms.device)
        sq = norms.square()
        return torch.sqrt(sharding.all_reduce_sum(sq[split].sum(), self.mesh.model_group)
                          + sq[~split].sum())

    def _check_finite(self, loss: torch.Tensor) -> None:
        """``training.debug_nans``: raise on a non-finite loss or gradient
        (every rank of the group together), naming the first parameter."""
        named = self._named_grads()
        bad = torch.stack([~torch.isfinite(loss).all()]
                          + [~torch.isfinite(g).all() for _, g in named]).to(torch.float32)
        bad = sharding.all_reduce_sum(bad)
        if bad[0] > 0:
            raise FloatingPointError(f"debug_nans: non-finite loss {float(loss.detach())}")
        for (n, _), b in zip(named, bad[1:].tolist()):
            if b > 0:
                raise FloatingPointError(f"debug_nans: non-finite gradient of {n}")

    def clip_and_step(self) -> None:
        """Global-norm clip (optax's formula) and the AdamW step at the
        groups' current lr scales."""
        named = self._named_grads()
        grads = [g for _, g in named]
        if self.grad_clip and self.grad_clip > 0 and grads:
            norm = self._global_norm(named)
            torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        lrs = self.scheduler.lrs()
        for group in self.optimizer.param_groups:
            group["lr"] = lrs[group["name"]]
        self.optimizer.step()

    def train_step(self, batch: TrainBatch) -> Dict[str, Any]:
        """One step on a host batch (a whole batch, or this rank's share of
        one) -> {"metrics": the global batch's losses, "timing": seconds,
        "rows": its samples}.  The forward (+ loss) and backward (+ clip and
        optimizer) times are CUDA-event times on the card, host clock times
        on the CPU."""
        t0 = time.perf_counter()
        batch = self.local_batch(batch)
        dev = self.to_device(batch)
        w, total = self.weights(batch)
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        self.trace.step()
        t1 = time.perf_counter()
        ld = self.forward_loss(*dev, w, total)
        if cuda:
            ev[1].record()
        t2 = time.perf_counter()
        self.optimizer.zero_grad(set_to_none=True)
        # DDP averages the D S ranks' gradients of S M times their shares:
        # D / M makes that average the gradient of the global batch's loss
        # (module docstring)
        scale = self.data_axis / self.mesh.model
        (ld["loss"] * scale if scale != 1 else ld["loss"]).backward()
        self._check_grads()
        if self.sharded:
            self._reduce_replicated()
        if self.debug_nans:
            self._check_finite(ld["loss"])
        self.clip_and_step()
        metrics = self._global_losses(ld, w)
        t3 = time.perf_counter()
        if cuda:
            ev[2].record()
            ev[2].synchronize()
            fwd, bwd = ev[0].elapsed_time(ev[1]) / 1e3, ev[1].elapsed_time(ev[2]) / 1e3
        else:
            fwd, bwd = t2 - t1, t3 - t2
        timing = {"data_time": t1 - t0, "forward_time": fwd, "backward_time": bwd,
                  "batch_time": time.perf_counter() - t0}
        rows = batch.images.shape[0] if total is None else int(total.item())
        return {"metrics": metrics, "timing": timing, "rows": rows}

    def _global_losses(self, ld: Dict[str, torch.Tensor], w) -> Dict[str, float]:
        """The losses as floats; with sample weights, the data indices'
        shares summed: the global batch's weighted means."""
        keys = list(ld)
        vals = torch.stack([ld[k].detach() for k in keys])
        if w is not None:
            vals = sharding.all_reduce_sum(vals, self.mesh.data_group)
        return dict(zip(keys, vals.tolist()))

    @torch.no_grad()
    def val_step(self, images, masks, edges, mask_hw, edge_hw, dst, nearest_idx,
                 sample_w=None, weight_total=None):
        """The forward in eval mode, as ``val_step`` (:381) applies the model
        without ``train``, the loss, and the metrics of the quantized masks
        and edge maps on the canvas (device tensors) -> (loss dict, seg
        metrics, edge metrics), each metric [B].  A model in train mode is
        put in eval mode for the step and back after it (each switch drops
        the cached int8 packs: :meth:`validate` switches once)."""
        switch = self.model.training
        if switch:
            self.model.eval()
        try:
            out = self.model(self._prep(images))
            ld = cod_loss(out["predictions"], out["edge"], masks, edges, mask_hw, edge_hw,
                          self.loss_cfg, sample_w, weight_total)
            canvas = tuple(masks.shape[1:3])
            pred_c, valid = resize_logits_to_canvas(out["predictions"][-1].float(), mask_hw,
                                                    canvas)
            seg = compute_batch_metrics(quantize_predictions(pred_c), masks, valid, mask_hw,
                                        dst, nearest_idx)
            edge_c, evalid = resize_logits_to_canvas(out["edge"].float(), edge_hw, canvas)
            edge_m = compute_batch_metrics(quantize_predictions(edge_c), edges, evalid, edge_hw)
        finally:
            if switch:
                self.model.train()
        return ld, seg, edge_m

    def validate(self, loader, epoch: int) -> Dict[str, float]:
        """Mean loss and metrics over the ValBatches of ``loader`` (``validate``
        :575), with the JAX trainer's keys: each batch's loss weighted by its
        samples, the metrics averaged over the samples.  Under a data axis
        above 1 each rank runs its rows of each batch (padded as
        :meth:`local_batch` pads) and the metrics of every real row are
        gathered in dataset order, so every rank reads the same means."""
        self.monitor.start_epoch()
        self.model.eval()
        records, offset = [], 0
        try:
            for batch in loader:
                t0 = time.perf_counter()
                batch = self.local_batch(batch)
                w, total = self.weights(batch)
                ld, seg, edge_m = self.val_step(*self.to_device(batch), w, total)
                cols = {key: rows.cpu().numpy() for key, rows in (
                    ("s_alpha", seg["sm"]), ("weighted_f", seg["wfm"]), ("mae", seg["mae"]),
                    ("e_phi", seg["em"]), ("mean_f", seg["fm"]), ("edge_mae", edge_m["mae"]),
                    ("edge_f", edge_m["fm"]))}
                n = batch.images.shape[0]
                first = offset + self.data_index * n
                records += [(first + j, {k: float(v[j]) for k, v in cols.items()})
                            for j in range(n) if (w is None or batch.sample_w[j] > 0)
                            and self.mesh.lead]
                offset += n * self.data_axis
                rows = n if total is None else int(total.item())
                self.monitor.update_batch(self._global_losses(ld, w),
                                          {"batch_time": time.perf_counter() - t0}, rows)
        finally:
            self.model.train()
        samples = sharding.gather_in_order(records)
        if samples:
            self.monitor.update_batch({k: float(np.mean([r[k] for r in samples]))
                                       for k in samples[0]}, {}, len(samples))
        stats = self.monitor.get_current_stats()
        logger.info(f"Validation {epoch + 1}/{self.num_epochs}: wF={stats['weighted_f']:.4f} "
                    f"Sa={stats['s_alpha']:.4f} MAE={stats['mae']:.4f}")
        return stats

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def train_epoch(self, loader, epoch: int) -> Dict[str, float]:
        self.monitor.start_epoch()
        for i, batch in enumerate(loader):
            res = self.train_step(batch)
            self.monitor.update_batch(res["metrics"], res["timing"], res["rows"])
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
        finally:
            self.trace.close()

    def _train(self, dataset_dirs: List[str]):
        dataset = concat_train_datasets(dataset_dirs)
        train_ds, val_ds = train_val_split(dataset, self.config.get("val_ratio", 0.1))
        logger.info(f"Training samples: {len(train_ds)}")
        if val_ds:
            logger.info(f"Validation samples: {len(val_ds)}")
        bf16 = self.model.config.dtype == torch.bfloat16
        wire_u8 = self.config.get("image_wire", "u8" if bf16 else "f32") == "u8"
        num_workers = self.config.get("num_workers", 4)
        best_weighted_f, early_stop, val_metrics = 0.0, 0, None
        for epoch in range(self.start_epoch, self.num_epochs):
            loader = train_loader(train_ds, self.processor, self.batch_size, self.buckets,
                                  shuffle=True, seed=epoch, num_workers=num_workers,
                                  image_u8=wire_u8, shard=(self.data_index, self.data_axis))
            self.train_epoch(loader, epoch)
            self.monitor.save_epoch(epoch, "train")
            train_metrics = self.monitor.get_current_stats()
            if val_ds:
                val_metrics = self.validate(self._val_loader(val_ds, num_workers), epoch)
                self.monitor.save_epoch(epoch, "val")
                self.scheduler.step(val_metrics["weighted_f"])
                if val_metrics["weighted_f"] - best_weighted_f > self.min_delta:
                    best_weighted_f = val_metrics["weighted_f"]
                    early_stop = 0
                    if self.monitor.check_best_model(val_metrics):
                        self.save_checkpoint(epoch, val_metrics, is_best=True)
                else:
                    early_stop += 1
                if early_stop >= self.early_stop_patience:
                    logger.info("Early stopping triggered")
                    break
            if (epoch + 1) % self.save_freq == 0:
                self.save_checkpoint(epoch, val_metrics or train_metrics, is_best=False)

    def _val_loader(self, val_ds, num_workers: int):
        return val_loader(val_ds, self.processor, self.batch_size, self.buckets,
                          num_workers=num_workers, shard=(self.data_index, self.data_axis))

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def checkpoint_state(self, epoch: int, metrics: Dict[str, float]) -> Dict[str, Any]:
        """The checkpoint in the reference schema; under the model axis every
        parameter and AdamW moment gathered (every rank of the model group
        calls it)."""
        opt = self.optimizer.state_dict()
        if self.sharded:
            opt = {**opt, "state": {i: {k: self._gather(i, v) for k, v in st.items()}
                                    for i, st in sorted(opt["state"].items())}}
        return {"model_state_dict": full_state_dict(self.model),
                "optimizer_state_dict": opt,
                "scheduler": self.scheduler.state_dict(),
                "epoch": epoch,
                "metrics": {k: float(v) for k, v in (metrics or {}).items()},
                "config": {"training": self.config, "model": self.model_config}}

    def _gather(self, i: int, v):
        """AdamW state ``v`` of the optimizer's parameter ``i``, gathered over
        the model group if the parameter is sharded."""
        name = self.param_names[i]
        if name not in self.sharded or not torch.is_tensor(v) or v.dim() == 0:
            return v
        return sharding.gather_param(name, v, self.mesh.model_shard)

    def save_checkpoint(self, epoch: int, metrics: Dict[str, float],
                        is_best: bool) -> Optional[Path]:
        """model_best.pth / checkpoint_{epoch:03d}.pth in the run's checkpoint
        directory (None without one, as on every rank but 0, which under the
        model axis take part in the gathers)."""
        if self.monitor.checkpoint_dir is None:
            if self.sharded:
                self.checkpoint_state(epoch, metrics)
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
        epoch (training continues at the next epoch); every rank loads it
        onto its own device, under the model axis its shards of every
        parameter and AdamW moment."""
        ckpt = torch.load(str(path), map_location=self.device, weights_only=False)
        load_sharded(self.model, ckpt["model_state_dict"])
        if resume:
            opt = ckpt["optimizer_state_dict"]
            if self.sharded:
                shard = self.mesh.model_shard
                opt = {**opt, "state": {
                    i: {k: sharding.shard_param(self.param_names[i], v, shard.index, shard.size)
                        if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
                    for i, st in opt["state"].items()}}
            self.optimizer.load_state_dict(opt)
            self.scheduler.load_state_dict(ckpt["scheduler"])
            self.start_epoch = ckpt["epoch"] + 1
            logger.info(f"Resumed from {path} at epoch {self.start_epoch}")
