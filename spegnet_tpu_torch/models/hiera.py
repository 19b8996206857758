"""Hiera trunk (SAM2 image encoder) in PyTorch (port of spegnet_tpu/models/hiera.py).

Parameter names are the reference state_dict keys (``patch_embed.proj``,
``pos_embed``, ``pos_embed_window``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, norm2, mlp.layers.{0,1}, proj}``).  Input and pyramid outputs are
channels-last, as in the JAX package.

Two compositions of the same blocks:

* ``kernels=True`` (default): after the patch embedding the trunk runs
  token-major in Morton order (ops/fused_block_t.to_z).  Non-pooling blocks
  go through ``fused_block_t`` (stages 1-3, global blocks included) or
  ``fused_block`` (the last stage), transitions through ``qpool_front``
  plus a plain proj/LN/MLP tail, and the pyramid outputs leave through
  ``from_z``.  The same code runs on the CPU (plain versions inside the
  wrappers) and on CUDA (the Hopper kernels).  It needs a square 2^k patch
  grid and windows no larger than the grid.
* ``kernels=False``: the decomposed NHWC path (window partition with zero
  padding, plain attention), the numerics anchor.

``int8=True`` (the flagged W8A8 encoder, inference only) sends the blocks
the JAX package sends to its int8 kernels to the port's int8 wrappers
(:func:`block_route`); their quantized weights are packed once per block
and kept until the block's parameters are reloaded, it changes mode, or the
compute dtype or device changes.  The decomposed path has no int8 form.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from spegnet_tpu_torch.models.layers import Conv2d, Linear, cast
from spegnet_tpu_torch.ops import fused_block_i8 as fb_i8
from spegnet_tpu_torch.ops import fused_block_t_i8 as fbt_i8
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.ops.attention import attention_reference
from spegnet_tpu_torch.ops.fused_block import fused_block
from spegnet_tpu_torch.ops.fused_block_t import (
    BlockWeights,
    QPoolWeights,
    from_z,
    fused_block_t,
    layer_norm,
    qpool_front,
    to_z,
)
from spegnet_tpu_torch.ops.resize import resize_bicubic


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int
    num_heads: int
    stages: Tuple[int, ...]
    global_att_blocks: Tuple[int, ...]
    window_pos_embed_bkg_spatial_size: Tuple[int, int]
    window_spec: Tuple[int, ...]
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        return tuple(sum(self.stages[: i + 1]) - 1 for i in range(len(self.stages)))

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[:3])

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * self.dim_mul**i) for i in range(len(self.stages)))


# Same table as the JAX package (spegnet_tpu/models/hiera.py:79).
HIERA_VARIANTS = {
    "tiny": HieraConfig(96, 1, (1, 2, 7, 2), (5, 7, 9), (7, 7), (8, 4, 14, 7)),
    "small": HieraConfig(96, 1, (1, 2, 11, 2), (7, 10, 13), (7, 7), (8, 4, 14, 7)),
    "base": HieraConfig(96, 1, (2, 3, 16, 3), (12, 16, 20), (14, 14), (8, 4, 14, 7)),
    "base_plus": HieraConfig(112, 2, (2, 3, 16, 3), (12, 16, 20), (14, 14), (8, 4, 14, 7)),
    "large": HieraConfig(144, 2, (2, 6, 36, 4), (23, 33, 43), (7, 7), (8, 4, 16, 8)),
    "huge": HieraConfig(256, 4, (2, 6, 36, 4), (23, 33, 43), (7, 7), (8, 4, 16, 8)),
    "test": HieraConfig(16, 1, (1, 1, 1, 1), (2,), (7, 7), (2, 2, 2, 2)),
}


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    dim: int
    dim_out: int
    heads: int
    q_pool: bool
    window: int     # 0 = global attention
    stage_end: bool
    stage: int      # 1-based stage the block's output belongs to


def block_specs(cfg: HieraConfig) -> List[BlockSpec]:
    """Per-block geometry, the spec loop of spegnet_tpu/models/hiera.py:765-780.
    A transition block keeps the previous stage's window size."""
    specs = []
    embed_dim, heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
    for i in range(cfg.depth):
        dim_out = embed_dim
        window = cfg.window_spec[cur_stage - 1]
        if i in cfg.global_att_blocks:
            window = 0
        if i - 1 in cfg.stage_ends:
            dim_out = int(embed_dim * cfg.dim_mul)
            heads = int(heads * cfg.head_mul)
            cur_stage += 1
        specs.append(BlockSpec(embed_dim, dim_out, heads, i in cfg.q_pool_blocks,
                               window, i in cfg.stage_ends, cur_stage))
        embed_dim = dim_out
    return specs


def block_route(spec: BlockSpec, l: int, n_tok: int, last_stage: bool, dtype: torch.dtype,
                int8: bool) -> str:
    """The wrapper (and launch counter) that one block of the Morton trunk
    runs, with windows of l tokens over n_tok tokens per image.  Under
    ``int8`` it follows spegnet_tpu/models/hiera.py: transitions take the
    int8 front where the bf16 front's gate and C % 32 allow (:409-421, bf16
    only); other blocks that pass the bf16 T-kernel's gate (bf16 only,
    :854-870) take the int8 T-block where C % 32 == 0 (:488-497, :916-935),
    and the rest the int8 gen-1 block where its gate allows (:597-609)."""
    if spec.q_pool:
        if (int8 and dtype == torch.bfloat16
                and fbt_i8.qpool_supported_i8(spec.dim, spec.heads, l, n_tok)):
            return "qpool_front_i8"
        return "qpool_front"
    if int8:
        if dtype == torch.bfloat16 and fbt_i8.supported(spec.dim, spec.heads, l, n_tok):
            if fbt_i8.supported_i8(spec.dim, spec.heads, l, n_tok):
                return "fused_block_t_i8"
        elif fb_i8.supported_i8(n_tok // l, l, spec.dim):
            return "fused_block_i8"
    return "fused_block" if last_stage else "fused_block_t"


def trunk_routes(cfg: HieraConfig, hw: int, dtype: torch.dtype, int8: bool) -> List[str]:
    """:func:`block_route` of every block of the trunk for a square hw x hw
    patch grid (a shape computation: nothing is allocated)."""
    out, last = [], len(cfg.stages)
    for sp in block_specs(cfg):
        l = sp.window * sp.window if sp.window else hw * hw
        out.append(block_route(sp, l, hw * hw, sp.stage == last, dtype, int8))
        if sp.q_pool:
            hw //= 2
    return out


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm parameters (kept in f32); statistics and affine in f32,
    result in the input dtype."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool of [B, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> [B * nWh * nWw, ws, ws, C], zero-padding H/W to ws."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w, :]


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)

    @property
    def head_dim(self) -> int:
        return self.dim_out // self.num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        d = self.head_dim
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, d)
        q, k, v = qkv.unbind(2)
        if self.q_pool:
            q = _max_pool_2x2(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, d)
        o = attention_reference(q, k, v)
        return self.proj(o.reshape(b, h, w, self.dim_out))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList([Linear(dim, hidden), Linear(hidden, out)])

    def forward(self, x: torch.Tensor, approx_gelu: bool) -> torch.Tensor:
        y = F.gelu(self.layers[0](x), approximate="tanh" if approx_gelu else "none")
        return self.layers[1](y)


class MultiScaleBlock(nn.Module):
    def __init__(self, spec: BlockSpec, mlp_ratio: float = 4.0):
        super().__init__()
        self.spec = spec
        self.norm1 = LayerNorm(spec.dim, eps=1e-6)
        self.attn = MultiScaleAttention(spec.dim, spec.dim_out, spec.heads, spec.q_pool)
        self.norm2 = LayerNorm(spec.dim_out, eps=1e-6)
        self.mlp = MLP(spec.dim_out, int(spec.dim_out * mlp_ratio), spec.dim_out)
        if spec.dim != spec.dim_out:
            self.proj = Linear(spec.dim, spec.dim_out)
        self._i8_cache = None   # ((dtype, device), packed int8 weights)

    def train(self, mode: bool = True):
        self._i8_cache = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._i8_cache = None
        super()._load_from_state_dict(*args, **kwargs)

    # -- decomposed NHWC path ------------------------------------------------
    def forward(self, x: torch.Tensor, approx_gelu: bool) -> torch.Tensor:
        ws = self.spec.window
        shortcut = x
        x = self.norm1(x)
        if self.spec.dim != self.spec.dim_out:
            p = self.proj(x)
            shortcut = _max_pool_2x2(p) if self.spec.q_pool else p
        hw = x.shape[1:3]
        pad_hw = hw
        if ws > 0:
            x, pad_hw = _window_partition(x, ws)
        x = self.attn(x)
        if self.spec.q_pool:
            ws //= 2
            hw = shortcut.shape[1:3]
            if ws > 0:
                pad_hw = (hw[0] + (ws - hw[0] % ws) % ws, hw[1] + (ws - hw[1] % ws) % ws)
        if self.spec.window > 0:
            x = _window_unpartition(x, ws, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x), approx_gelu)

    # -- Morton kernel path --------------------------------------------------
    def block_weights(self, dt: torch.dtype) -> BlockWeights:
        """Matmul weights cast to the compute dtype ``dt``; norms stay f32."""
        a, m = self.attn, self.mlp.layers
        return BlockWeights(self.norm1.weight, self.norm1.bias, *(
            cast(p, dt) for p in (a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias)),
            self.norm2.weight, self.norm2.bias, *(
            cast(p, dt) for p in (m[0].weight, m[0].bias, m[1].weight, m[1].bias)))

    def qpool_weights(self, dt: torch.dtype) -> QPoolWeights:
        a = self.attn
        return QPoolWeights(self.norm1.weight, self.norm1.bias, *(
            cast(p, dt) for p in (a.qkv.weight, a.qkv.bias, self.proj.weight, self.proj.bias)))

    def i8_weights(self, dt: torch.dtype):
        """The block's W8A8 weights, packed from its ``dt`` weights on first
        use and cached (outside inference mode, so a later forward with
        autograd on may read them)."""
        key = (dt, self.norm1.weight.device)
        if self._i8_cache is None or self._i8_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                w = (fbt_i8.pack_qpool_i8(self.qpool_weights(dt)) if self.spec.q_pool
                     else fbt_i8.pack_i8(self.block_weights(dt)))
            self._i8_cache = (key, w)
        return self._i8_cache[1]

    def forward_z(self, x: torch.Tensor, l: int, route: str,
                  approx_gelu: bool) -> torch.Tensor:
        """Non-pooling block on Morton [B, N, C] with windows of l tokens,
        through the wrapper ``route`` (:func:`block_route`)."""
        scale = self.attn.head_dim ** -0.5
        heads = self.spec.heads
        b, n, c = x.shape
        if route == "fused_block_t_i8":
            return fbt_i8.fused_block_t_i8(x, self.i8_weights(x.dtype), heads, l, scale,
                                           1e-6, approx_gelu)
        if route in ("fused_block", "fused_block_i8"):
            xw = x.reshape(b * n // l, l, c)
            if route == "fused_block":
                y = fused_block(xw, self.block_weights(x.dtype), heads, scale, 1e-6,
                                approx_gelu)
            else:
                y = fb_i8.fused_block_i8(xw, self.i8_weights(x.dtype), heads, scale, 1e-6,
                                         approx_gelu)
            return y.reshape(b, n, c)
        return fused_block_t(x, self.block_weights(x.dtype), heads, l, scale, 1e-6,
                             approx_gelu)

    def forward_qpool_z(self, x: torch.Tensor, l: int, route: str,
                        approx_gelu: bool) -> torch.Tensor:
        """Transition on Morton [B, N, Cin] -> [B, N/4, Cout]: the kernel
        front (int8 for ``route`` "qpool_front_i8"), then proj + LN2 + MLP in
        plain PyTorch (outside the TPU kernel too,
        spegnet_tpu/models/hiera.py:422-443)."""
        a, dt = self.attn, x.dtype
        scale = a.head_dim ** -0.5
        if route == "qpool_front_i8":
            o, sc = fbt_i8.qpool_front_i8(x, self.i8_weights(dt), self.spec.heads, l, scale,
                                          1e-6)
        else:
            o, sc = qpool_front(x, self.qpool_weights(dt), self.spec.heads, l, scale, 1e-6)
        out1 = sc + a.proj(o)
        return out1 + self.mlp(self.norm2(out1), approx_gelu)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, kernel_size=7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/4, W/4, C]."""
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def compute_pos_embed(bkg: torch.Tensor, win: torch.Tensor, hw) -> torch.Tensor:
    """Bicubic-resized background embed [1, C, Hb, Wb] plus the tiled window
    embed [1, C, ws, ws] -> [1, h, w, C] in f32 (SAM2's ``_get_pos_embed``)."""
    h, w = hw
    pe = resize_bicubic(wide(bkg).permute(0, 2, 3, 1), (h, w))
    win = wide(win).permute(0, 2, 3, 1)
    return pe + win.repeat(1, h // win.shape[1], w // win.shape[2], 1)


def _pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


class Hiera(nn.Module):
    """The trunk: NHWC [B, H, W, 3] (H, W divisible by 32) -> the 4-stage
    channels-last pyramid."""

    def __init__(self, variant: str = "large"):
        super().__init__()
        cfg = HIERA_VARIANTS[variant]
        self.config = cfg
        self.specs = block_specs(cfg)
        self.patch_embed = PatchEmbed(cfg.embed_dim)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, *cfg.window_pos_embed_bkg_spatial_size))
        ws0 = cfg.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, ws0, ws0))
        self.blocks = nn.ModuleList(MultiScaleBlock(s, cfg.mlp_ratio) for s in self.specs)

    def forward(self, x: torch.Tensor, kernels: bool = True,
                dtype: torch.dtype = torch.float32, int8: bool = False) -> List[torch.Tensor]:
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError("Input spatial dims must be divisible by 32")
        approx_gelu = dtype == torch.bfloat16
        x = self.patch_embed(x.to(dtype))
        x = x + compute_pos_embed(self.pos_embed, self.pos_embed_window,
                                  x.shape[1:3]).to(dtype)
        if not kernels:
            outputs = []
            for blk in self.blocks:
                x = blk(x, approx_gelu)
                if blk.spec.stage_end:
                    outputs.append(x)
            return outputs
        return self._forward_z(x, approx_gelu, int8)

    def _forward_z(self, x: torch.Tensor, approx_gelu: bool,
                   int8: bool = False) -> List[torch.Tensor]:
        _, h, w, _ = x.shape
        if h != w or not _pow2(h):
            raise ValueError(f"the kernel path needs a square 2^k patch grid, got {(h, w)}")
        routes = trunk_routes(self.config, h, x.dtype, int8)
        x = to_z(x)
        outputs = []
        for i, (blk, route) in enumerate(zip(self.blocks, routes)):
            sp = blk.spec
            if sp.window > h:
                raise ValueError(f"window {sp.window} exceeds the {h}x{w} grid of block "
                                 f"{i}; use kernels=False")
            l = sp.window * sp.window if sp.window else h * w
            if sp.q_pool:
                x = blk.forward_qpool_z(x, l, route, approx_gelu)
                h, w = h // 2, w // 2
            else:
                x = blk.forward_z(x, l, route, approx_gelu)
            if sp.stage_end:
                outputs.append(from_z(x, (h, w)))
        return outputs
