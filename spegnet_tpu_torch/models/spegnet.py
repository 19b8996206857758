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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from spegnet_tpu_torch.models.cfi import AdaptiveAttentionFusion, EfficientASPP
from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, Hiera
from spegnet_tpu_torch.models.ped import BoundaryAwareDecoder, EdgeDetectionModule


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
    # The flagged W8A8 encoder (ops/fused_block_t_i8.py, ops/fused_block_i8.py),
    # honoured in eval mode only, as the JAX package's ``int8_encoder and not
    # train``.  The W8A8 decoder block (``int8_decoder``) is not ported.
    int8_encoder: bool = False
    int8_decoder: bool = False

    @classmethod
    def from_dict(cls, model_config: Dict[str, Any]) -> "SPEGNetConfig":
        enc = model_config.get("encoder", {})
        return cls(variant=enc.get("variant", "large"),
                   compute_dtype=model_config.get("compute_dtype", "float32"),
                   int8_encoder=bool(model_config.get("int8_encoder", False)),
                   int8_decoder=bool(model_config.get("int8_decoder", False)))

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
    W8A8 encoder blocks (models/hiera.py ``block_route``)."""

    def __init__(self, config: SPEGNetConfig = SPEGNetConfig(), kernels: bool = True):
        super().__init__()
        if config.int8_decoder:
            raise NotImplementedError(
                "model.int8_decoder (the W8A8 decoder block) is not ported to PyTorch yet; "
                "see ROADMAP.md")
        self.config = config
        self.kernels = kernels
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
        dtype (norms and position embeddings stay f32)."""
        if device is not None:
            self.to(device)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(self.config.dtype)
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        dt = self.config.dtype
        feats = self.encoder.encoder(x, kernels=self.kernels, dtype=dt,
                                     int8=self.config.int8_encoder and not self.training)
        s2, s3, s4 = (f.permute(0, 3, 1, 2) for f in feats[1:4])
        fused = self.fusion([s2, s3, s4])
        context = self.context(fused)
        edge_map, edge_features = self.edge_detector(context)
        preds = self.decoder(context, edge_features, kernels=self.kernels)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {
            "predictions": [nhwc(p) for p in preds],
            "edge": nhwc(edge_map),
            "features": {"context": nhwc(context), "fused": nhwc(fused),
                         "edge_features": nhwc(edge_features)},
        }
