"""SPEGNet composition root: Hiera encoder -> CFI -> EFE -> PED
(port of spegnet_tpu/models/spegnet.py).

Input is channels-last [B, H, W, 3] (normalized); outputs are logits,
channels-last, in the same dict as the JAX model:
``predictions`` ([B, H/4, W/4, 1], [B, H/2, W/2, 1], [B, H, W, 1]),
``edge`` [B, H/8, W/8, 1] and ``features`` (context, fused, edge_features).

Parameters keep the reference state_dict keys, so ``load_state_dict``
takes a reference ``.pth``'s ``model_state_dict`` or
utils/weights.state_dict_from_jax(...) directly.  Matmul and conv weights
run in the compute dtype: cast at use from f32 master weights in training
(models/layers.py), or cast once by :meth:`SPEGNet.to_compute` for
predict; LayerNorm, BatchNorm and the position embeddings stay in f32, as
in the JAX package.  ``model.train()`` switches BatchNorm to batch
statistics and decoder block 2 to the decomposed path.

Under a spatial axis (``config.spatial_axis``, a group of S > 1 ranks) the
head -- CFI, EFE and PED -- runs on row bands where
models/hiera.head_bands allows (S divides H/8), as JAX's head runs H-sharded
over its axis (its trunk's outputs constrained to P("data", sp, None,
None), spegnet_tpu/models/hiera.py:710-724): rank s of the group computes
rows [s h / S, (s + 1) h / S) of every head map of h rows (H/8, H/4, H/2,
H), reading its band's source rows from the whole stage outputs and
fetching from the other ranks only the halo rows its convolutions and
resizes read (parallel/sharding.halo); the spatial means and the
BatchNorm statistics sum over the bands.  The outputs are then gathered
along H (parallel/sharding.gather_rows), so every output is whole on every
rank, as without bands.  Elsewhere the head runs whole on every rank,
logged once per shape.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from spegnet_tpu_torch.models.cfi import AdaptiveAttentionFusion, EfficientASPP
from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, Hiera, gathered_blocks, head_bands
from spegnet_tpu_torch.models.ped import BoundaryAwareDecoder, EdgeDetectionModule
from spegnet_tpu_torch.parallel.mesh import ModelShard, TokenShard
from spegnet_tpu_torch.parallel.sharding import (
    RowBand,
    gather_rows,
    halo,
    shard_dim,
    shard_param,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SPEGNetConfig:
    """Model hyperparameters (schema-compatible with configs/default.yaml)."""

    variant: str = "large"
    fusion_channels: int = 512
    context_channels: int = 256
    edge_channels: int = 64
    decoder_channels: Sequence[int] = (256, 128, 64)
    n_classes: int = 1
    compute_dtype: str = "float32"
    # The flagged W8A8 encoder (ops/fused_block_t_i8.py, ops/fused_block_i8.py)
    # and decoder block 2 (ops/fused_decoder.py ``int8=True``), honoured in
    # eval mode on the kernel path only, as the JAX package's ``int8_encoder
    # and not train`` / ``int8_decoder and not train``.
    int8_encoder: bool = False
    int8_decoder: bool = False
    # Recompute the trunk's decomposed blocks in the backward (models/hiera.py;
    # the trainer sets it from training.remat, else batch per rank > 16).
    remat: bool = False
    # The parallel.mesh axis whose ranks split the Morton trunk's tokens
    # (sequence parallelism, models/hiera.py ``trunk_plan``); the engines
    # hand the model its group (SPEGNet.shard_tokens).
    spatial_axis: Optional[str] = None

    @classmethod
    def from_dict(cls, model_config: Dict[str, Any]) -> "SPEGNetConfig":
        """The model section of a config."""
        enc = model_config.get("encoder", {})
        return cls(variant=enc.get("variant", "large"),
                   compute_dtype=model_config.get("compute_dtype", "float32"),
                   int8_encoder=bool(model_config.get("int8_encoder", False)),
                   int8_decoder=bool(model_config.get("int8_decoder", False)),
                   remat=bool(model_config.get("remat", False)),
                   spatial_axis=model_config.get("spatial_axis") or None)

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}[self.compute_dtype]


class HieraEncoder(nn.Module):
    """Holds the trunk at ``.encoder`` (reference key prefix encoder.encoder.*)."""

    def __init__(self, variant: str):
        super().__init__()
        self.encoder = Hiera(variant)


class SPEGNet(nn.Module):
    """``kernels=True`` runs the Morton trunk and decoder block 2 through the
    kernel wrappers (plain versions on the CPU, Hopper kernels on CUDA);
    ``kernels=False`` runs the decomposed plain path everywhere.  With
    ``config.int8_encoder`` an eval-mode forward on the kernel path runs the
    W8A8 encoder blocks (models/hiera.py ``block_route``), with
    ``config.int8_decoder`` decoder block 2 in its W8A8 mode (bf16 compute,
    block 2's input channels a multiple of 128, as the TPU's gates).  With
    ``config.remat`` a training forward recomputes the trunk's decomposed
    blocks in the backward (models/hiera.py).

    With ``config.spatial_axis`` the trunk runs under sequence parallelism
    over the group :meth:`shard_tokens` was given (none: a spatial axis of
    size 1, JAX's routes there), and decoder block 2 takes the decomposed
    path, as JAX's ``fused_ok=cfg.spatial_axis is None``
    (spegnet_tpu/models/spegnet.py:102-106).  The head after the trunk runs
    on this rank's band of rows (:meth:`head`, module docstring) where
    models/hiera.head_bands allows, else whole.

    After :meth:`shard_model` (the ``model`` axis of ``parallel.mesh``) the
    encoder's qkv, attention proj, fc1 and fc2 hold this rank's shards
    (parallel/sharding.param_spec) and the trunk runs on them
    (models/hiera.py); everything else is replicated.  ``state_dict`` then
    holds the shards: utils/weights.full_state_dict gathers the reference
    schema and utils/weights.load_sharded loads one.  Both may be applied
    to one model (``parallel.mesh: {data: D, sp: S, model: M}``, training):
    the trunk then runs on its token shard with its matmuls split
    (models/hiera.py), and the decoder stays decomposed."""

    def __init__(self, config: SPEGNetConfig = SPEGNetConfig(), kernels: bool = True):
        super().__init__()
        self.config = config
        self.kernels = kernels
        self.token_shard: Optional[TokenShard] = None
        self.model_shard: Optional[ModelShard] = None
        self._whole_logged = set()   # the input shapes whose head ran whole, logged
        self.encoder = HieraEncoder(config.variant)
        ch = HIERA_VARIANTS[config.variant].channels
        self.fusion = AdaptiveAttentionFusion(ch[1:4], config.fusion_channels)
        self.context = EfficientASPP(config.fusion_channels, config.context_channels)
        self.edge_detector = EdgeDetectionModule(config.context_channels,
                                                 config.edge_channels)
        ec = config.edge_channels
        self.decoder = BoundaryAwareDecoder(config.context_channels,
                                            tuple(config.decoder_channels),
                                            config.n_classes, (ec, ec, None))

    def to_compute(self, device: Optional[torch.device] = None) -> "SPEGNet":
        """Move to ``device`` and cast every Linear / Conv2d to the compute
        dtype (norms and position embeddings stay f32).  With
        ``int8_decoder``, decoder block 2's convs stay f32 too and are cast
        where they are used: the int8 mode packs them from f32, composing
        and folding BN before the one rounding to the compute dtype, as the
        JAX package packs its f32 parameters (ops/fused_decoder.pack_params)."""
        if device is not None:
            self.to(device)
        keep = set()
        if self.config.int8_decoder:
            blk = self.decoder.decoder_blocks[-1]
            keep = {id(blk.conv1), id(blk.conv2)}
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)) and id(m) not in keep:
                m.to(self.config.dtype)
        return self

    def shard_tokens(self, shard: Optional[TokenShard]) -> "SPEGNet":
        """The spatial group whose ranks split the trunk's tokens
        (parallel/mesh.Mesh.token_shard; None for a spatial axis of size
        1).  Every rank of the group must run the same forwards."""
        self.token_shard = shard
        return self

    def shard_model(self, shard: Optional[ModelShard]) -> "SPEGNet":
        """Split the encoder's large matmuls over the model group
        (parallel/mesh.Mesh.model_shard; None or M = 1 leaves the model as
        it is): each parameter that ``param_spec`` splits becomes this
        rank's shard of the full tensor it holds now.  Call it once, on
        the full weights (the same on every rank of the group), before an
        optimizer takes the parameters."""
        if shard is None or shard.size == 1:
            return self
        if self.model_shard is not None:
            raise RuntimeError("shard_model: the model is already sharded")
        with torch.no_grad():
            for name, p in self.named_parameters():
                if shard_dim(name) is not None:
                    p.data = shard_param(name, p.data, shard.index, shard.size)
        for blk in self.encoder.encoder.blocks:
            blk.shard_model(shard)
        self.model_shard = shard
        gathered = gathered_blocks(self.encoder.encoder.config, shard.size)
        if gathered:
            logger.info(f"model axis of {shard.size}: blocks {gathered} have heads it does "
                        "not divide; their decomposed attention gathers its qkv "
                        "(models/hiera.gathered_blocks)")
        return self

    def head_band(self, hw) -> Optional[RowBand]:
        """This rank's band of the head for an input of ``hw`` pixels ((H,
        W)): None without a spatial group of more than one rank, or where
        models/hiera.head_bands refuses (logged once per shape)."""
        shard = self.token_shard
        if self.config.spatial_axis is None or shard is None or shard.size == 1:
            return None
        if head_bands(tuple(hw), shard.size) is None:
            if (tuple(hw), shard.size) not in self._whole_logged:
                self._whole_logged.add((tuple(hw), shard.size))
                logger.info(f"spatial axis of {shard.size}, input {tuple(hw)}: H/8 does not "
                            "divide over the group; the head runs whole on every rank of "
                            "it (models/hiera.head_bands)")
            return None
        return RowBand(shard.group, shard.index, shard.size)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        dt = self.config.dtype
        spatial = self.config.spatial_axis is not None
        shard = (self.token_shard or TokenShard(None, 0, 1)) if spatial else None
        feats = self.encoder.encoder(x, kernels=self.kernels, dtype=dt,
                                     int8=self.config.int8_encoder and not self.training,
                                     remat=self.config.remat and self.training
                                     and torch.is_grad_enabled(), shard=shard)
        return self.head([f.permute(0, 3, 1, 2) for f in feats[1:4]],
                         self.head_band(x.shape[1:3]))

    def head(self, feats, band: Optional[RowBand] = None) -> Dict[str, Any]:
        """CFI, EFE and PED on the whole stage 2-4 outputs ``feats`` (NCHW),
        on every row, or with ``band`` on this rank's band of rows, the
        outputs gathered: either way the model's outputs, whole."""
        s2, s3, s4 = feats
        if band is None:
            fused = self.fusion([s2, s3, s4])
            context = self.context(fused)
            edge_map, edge_features = self.edge_detector(context)
            preds = self.decoder(context, edge_features,
                                 kernels=self.kernels and self.config.spatial_axis is None,
                                 int8=self.config.int8_decoder and not self.training)
        else:
            fused = self.fusion([s2, s3, s4], band)
            context = self.context(fused, band)
            rows = halo(context, band, 1, 1)
            edge_map, edge_features = self.edge_detector(rows, band)
            preds = self.decoder(rows, halo(edge_features, band, 1, 1), band=band)
            *preds, edge_map = gather_rows(preds + [edge_map], band)
            context, fused, edge_features = gather_rows([context, fused, edge_features], band)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {
            "predictions": [nhwc(p) for p in preds],
            "edge": nhwc(edge_map),
            "features": {"context": nhwc(context), "fused": nhwc(fused),
                         "edge_features": nhwc(edge_features)},
        }
