"""Hiera trunk (SAM2 image encoder) in PyTorch (port of spegnet_tpu/models/hiera.py).

Parameter names are the reference state_dict keys (``patch_embed.proj``,
``pos_embed``, ``pos_embed_window``, ``blocks.{i}.{norm1, attn.qkv,
attn.proj, norm2, mlp.layers.{0,1}, proj}``).  Input and pyramid outputs are
channels-last, as in the JAX package.

Two compositions of the same blocks:

* ``kernels=True`` (default): each block goes through the wrapper its
  route names (:func:`trunk_routes`).  In bf16 on a square 2^k patch grid
  whose windows fit it, the trunk runs token-major in Morton order
  (ops/fused_block_t.to_z): non-pooling blocks go through ``fused_block_t``
  (stages 1-3, global blocks included) or ``fused_block`` (the last stage),
  transitions through ``qpool_front`` plus a plain proj/LN/MLP tail, and
  the pyramid outputs leave through ``from_z``.  On any other grid, and in
  any other dtype, the blocks are routed as the JAX package routes them
  there (its non-Morton branch, spegnet_tpu/models/hiera.py:850-947 and
  :499-645; it takes Morton order, the T-block and the transition front in
  bf16 only, :806-812, :854-866, :509-517): those two where their gates
  allow, the gen-1 block on divisible windows of 16-64 tokens, on the
  window-major token layout (ops/fused_block_t.to_w); the rest on the
  decomposed NHWC path, whose attention goes through
  ``fused_attention_lanes`` where its gate allows (all of stages 3-4 of
  Hiera-L at 352^2, 384^2, 640^2, and in f32 at every size).  The same code
  runs on the CPU (plain versions inside the wrappers) and on CUDA (the
  Hopper kernels, bf16 and f32).
* ``kernels=False``: the decomposed NHWC path (window partition with zero
  padding, plain attention), the numerics anchor.

``int8=True`` (the flagged W8A8 encoder, inference only) sends the blocks
the JAX package sends to its int8 kernels to the port's int8 wrappers
(:func:`block_route`, :func:`grid_route`): in bf16 the int8 T-block, front
and gen-1 block, in f32 the int8 gen-1 block.  Their quantized weights are
packed once per block and kept until the block's parameters are reloaded,
it changes mode, or the compute dtype or device changes.  The decomposed
path has no int8 form.

``shard`` (sequence parallelism, ``model.spatial_axis``; the JAX package's
``spatial_axis``, :720-744): the S ranks of a spatial group split the bf16
Morton trunk into S contiguous token ranges, whole windows and pool groups
each, so the T-block and the front run their kernels on local rows with no
halo; global blocks gather K and V over the group; what JAX's gates refuse
at the local token count runs whole on every rank (:func:`trunk_plan`).
The stage outputs leave the trunk whole on every rank; the head takes its
rows from them (:func:`head_bands`, models/spegnet.py).

``tp`` (the model axis, ``parallel.mesh: {data: D, model: M}``; JAX's
``model`` axis, spegnet_tpu/parallel/sharding.py:39-75): each block holds
1/M of its qkv, attention proj, fc1 and fc2 (parallel/sharding.param_spec;
models/spegnet.py ``SPEGNet.shard_model``), and the M ranks of a model
group run the same rows.  The decomposed blocks run Megatron-style on the
shards (:class:`MultiScaleAttention`, :class:`MLP`): qkv and attention on
this rank's heads (``fused_attention_lanes`` on H / M heads), proj on the
matching input features, then the all-reduce of the partial sums; fc1 on
this rank's hidden columns, GELU, fc2 on the matching rows, then the
all-reduce.  An attention whose heads the axis does not divide
(:func:`gathered_blocks`) takes its qkv gathered and runs every head, then
the same row-parallel proj.  The kernel blocks (T-block, front, gen-1
block and their int8 forms) take the full weights, all-gathered per block
at use (:meth:`MultiScaleBlock.block_weights`), as JAX's shard_map'd
kernels take their weights gathered by GSPMD; the transition's tail after
the front (proj, LN2, MLP) runs Megatron-style.  Routes and launches do not
change with the axis.

Both (``parallel.mesh: {data: D, sp: S, model: M}``, the spatial axis
named): the plan is :func:`trunk_plan` under S, whatever M.  A sharded
T-block or front runs its kernel on this rank's token rows with the
weights gathered over the model group; the front's tail runs
Megatron-style on those rows (its row-parallel all-reduce sums [B, N / S,
C] partials over the model group); a global block takes
``block_global_sp`` with K / V gathered over the spatial group and its
full weights gathered over the model group; the blocks that run whole (the
last stage's gen-1 blocks at 512^2, every block on a grid that is not 2^k)
run on every rank of the spatial group as they run under M alone.  Under
``remat`` the checkpointed global block gathers its weights and K / V again
in the recompute, in the forward's order.  Deliberate differences from JAX
under the two axes: what runs whole in the trunk runs on every rank of the
spatial group on the same rows (JAX lets GSPMD shard it), and the global
blocks and the fronts take their weights gathered over the model group
where GSPMD may instead shard their attention by heads.

``remat=True`` (training, models/spegnet.py; the JAX package's
``Hiera.remat``, :752-758, :937-940) recomputes the decomposed blocks in
the backward pass (non-reentrant ``torch.utils.checkpoint``), keeping only
the outputs of their matmuls (``aten.mm`` / ``aten.addmm``), as JAX's
``dots_with_no_batch_dims_saveable`` keeps its dots.  The kernel blocks stay
as they are: the T-block, the transition front and the gen-1 block keep only
their input and weights for a backward that recomputes (their autograd
Functions; the f32 gen-1 block's backward recomputes through the plain
block), so an outer checkpoint would only run their forward kernel twice
(spegnet_tpu/engine/trainer.py:186-192).  A checkpointed block whose
attention is ``fused_attention_lanes`` launches that kernel again in the
backward.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from spegnet_tpu_torch.models.layers import Conv2d, Linear, cast
from spegnet_tpu_torch.ops import fused_block as fb
from spegnet_tpu_torch.ops import fused_block_i8 as fb_i8
from spegnet_tpu_torch.ops import fused_block_t as fbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as fbt_i8
from spegnet_tpu_torch.ops import wide
from spegnet_tpu_torch.ops.attention import attention_reference, scaled_dot_product_attention
from spegnet_tpu_torch.ops.fused_block import fused_block
from spegnet_tpu_torch.ops.fused_block_t import (
    BlockWeights,
    QPoolWeights,
    from_w,
    fused_block_t,
    keeps_windows,
    layer_norm,
    qpool_front,
    to_w,
    to_z,
)
from spegnet_tpu_torch.ops.pallas_attention import fused_attention_lanes, lanes_supported
from spegnet_tpu_torch.ops.resize import resize_bicubic
from spegnet_tpu_torch.parallel.mesh import ModelShard, TokenShard
from spegnet_tpu_torch.parallel.sharding import gather_tokens, gather_weights, reduce_partial

logger = logging.getLogger(__name__)


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


# Routes that run on the token-major layouts (Morton or window-major); the
# others ("fused_attention_lanes", "plain") run the decomposed NHWC block.
TOKEN_ROUTES = ("fused_block_t", "fused_block", "qpool_front", "fused_block_t_i8",
                "fused_block_i8", "qpool_front_i8")


def block_route(spec: BlockSpec, l: int, n_tok: int, last_stage: bool, int8: bool) -> str:
    """The wrapper (and launch counter) that one block of the Morton trunk
    (bf16) runs, with windows of l tokens over n_tok tokens per image.
    Under ``int8`` it follows spegnet_tpu/models/hiera.py: transitions take
    the int8 front where the bf16 front's gate and C % 32 allow (:409-421);
    other blocks that pass the T-kernel's gate (:854-870) take the int8
    T-block where C % 32 == 0 (:488-497, :916-935), and the rest the int8
    gen-1 block where its gate allows (:597-609)."""
    if spec.q_pool:
        if int8 and fbt_i8.qpool_supported_i8(spec.dim, spec.heads, l, n_tok):
            return "qpool_front_i8"
        return "qpool_front"
    if int8:
        if fbt.supported(spec.dim, spec.heads, l, n_tok):
            if fbt_i8.supported_i8(spec.dim, spec.heads, l, n_tok):
                return "fused_block_t_i8"
        elif fb_i8.supported_i8(n_tok // l, l, spec.dim):
            return "fused_block_i8"
    return "fused_block" if last_stage else "fused_block_t"


def grid_route(spec: BlockSpec, h: int, w: int, dtype: torch.dtype, int8: bool,
               t_block: bool = True) -> str:
    """The route of one block on an h x w patch grid outside the Morton
    path, by the JAX package's gates for compute dtype ``dtype``: in bf16
    the transition front where ``use_qpool_t`` holds
    (spegnet_tpu/models/hiera.py:509-517) and the T-block where ``can_t``
    does (:854-866), both bf16 only; in every dtype the gen-1 block on
    divisible windows of 16 to 64 tokens (:566-574), whose gate ignores the
    dtype; each in its int8 form under ``int8`` where the int8 gate allows
    (:543, :488-491, :597); else the decomposed block, whose attention is
    ``fused_attention_lanes`` where ``lanes_supported`` holds (:296-300) and
    "plain" otherwise (the Q-pool blocks, whose q is shorter than k).
    ``t_block`` False closes the T-block (JAX's ``can_t``, :854-856, under a
    spatial axis of one process or outside the Morton trunk of a larger
    one); the transition front's gate does not look at the spatial axis
    (:509-517)."""
    ws = spec.window
    l = ws * ws if ws else h * w
    n_tok = h * w
    divisible = ws == 0 or (h % ws == 0 and w % ws == 0)
    bf16 = dtype == torch.bfloat16
    if spec.q_pool:
        if (bf16 and spec.dim != spec.dim_out and ws > 1 and ws % 2 == 0 and divisible
                and fbt.qpool_supported(spec.dim, spec.heads, l, n_tok)):
            if int8 and fbt_i8.qpool_supported_i8(spec.dim, spec.heads, l, n_tok):
                return "qpool_front_i8"
            return "qpool_front"
        return "plain"
    if spec.dim == spec.dim_out and divisible:
        if t_block and bf16 and fbt.supported(spec.dim, spec.heads, l, n_tok):
            if int8 and fbt_i8.supported_i8(spec.dim, spec.heads, l, n_tok):
                return "fused_block_t_i8"
            return "fused_block_t"
        if fb.supported(l):
            if int8 and fb_i8.supported_i8(n_tok // l, l, spec.dim):
                return "fused_block_i8"
            return "fused_block"
    if lanes_supported(l, spec.dim_out // spec.heads):
        return "fused_attention_lanes"
    return "plain"


def morton_grid(cfg: HieraConfig, h: int, w: int) -> bool:
    """Whether an h x w patch grid suits the Morton path: square, 2^k, and
    every block's window no larger than its grid."""
    if h != w or not _pow2(h):
        return False
    for sp in block_specs(cfg):
        if sp.window > h:
            return False
        if sp.q_pool:
            h //= 2
    return True


def takes_morton(cfg: HieraConfig, h: int, w: int, dtype: torch.dtype) -> bool:
    """Whether the trunk runs in Morton order: bf16 (JAX's ``use_z`` and
    ``can_t``, spegnet_tpu/models/hiera.py:806-812, :854-866) on a
    :func:`morton_grid` grid."""
    return dtype == torch.bfloat16 and morton_grid(cfg, h, w)


def sp_takes_morton(h: int, w: int, dtype: torch.dtype) -> bool:
    """Whether the trunk runs in Morton order under a spatial axis above 1
    (JAX's ``use_z`` there, spegnet_tpu/models/hiera.py:806-813): bf16 on a
    square 2^k patch grid.  Unlike :func:`takes_morton` it does not ask every
    window to fit its grid: a block whose gate refuses leaves the order, and
    a later one may take it again, as in JAX."""
    return dtype == torch.bfloat16 and h == w and _pow2(h)


def trunk_plan(cfg: HieraConfig, hw, dtype: torch.dtype, int8: bool,
               train_batch: Optional[int] = None,
               sp: Optional[int] = None) -> List[Tuple[str, bool]]:
    """(route, sharded) of every block: the route of :func:`trunk_routes`
    and whether the block runs on this rank's token shard (sequence
    parallelism) or on the whole input.

    ``sp`` None: no spatial axis, every block whole.  ``sp`` S (the config
    names ``model.spatial_axis``; S its size in the mesh) follows JAX's gates
    under that axis (spegnet_tpu/models/hiera.py:806-866):

    * S = 1: no Morton order and no T-block (``use_z`` and ``can_t`` need
      the axis unset or above 1); the rest as :func:`grid_route`;
    * S > 1 on a :func:`sp_takes_morton` grid: the Morton trunk split into S
      contiguous token ranges.  A transition takes the front in the order
      (:829-839), a non-pooling block the T-block (:854-866), where the
      tokens divide over S and the kernel's gate holds at the *local* count
      h w / S; a global block takes "global_ref" (:853, :897-908:
      ops/fused_block_t.block_global_sp, plain PyTorch with K / V gathered,
      not a kernel counter) wherever the tokens divide.  Those run sharded;
      any other block leaves the order and runs whole on the route
      :func:`grid_route` gives without the T-block, as JAX's NHWC path
      there; a later block may shard again.  The int8 token routes are off,
      as JAX's (:409, :488, :920); the int8 gen-1 block and front of the
      NHWC path are not;
    * S > 1 elsewhere (f32, a grid that is not 2^k): every block whole, on
      the routes of one process without the axis.

    A deliberate difference from JAX under the axis: what runs whole runs
    on every rank of the spatial group on the same data (JAX lets GSPMD
    shard it: its T-blocks on the window-major layout of a grid that is not
    2^k, and every NHWC block by H).  The head after the trunk runs on row
    bands where :func:`head_bands` allows, as JAX's H-sharded head
    (models/spegnet.py)."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    if sp is None or sp > 1 and not sp_takes_morton(h, w, dtype):
        return [(r, False) for r in trunk_routes(cfg, (h, w), dtype, int8, train_batch)]
    out, in_z = [], False
    for spec in block_specs(cfg):
        ws, n = spec.window, h * w
        l = ws * ws if ws else n
        local = sp > 1 and n % sp == 0
        if (in_z and spec.q_pool and spec.dim != spec.dim_out and ws > 1 and ws % 2 == 0
                and _pow2(ws) and ws <= h and local
                and fbt.qpool_supported(spec.dim, spec.heads, l, n // sp)):
            out.append(("qpool_front", True))
        else:
            glob = ws == 0
            in_z = (local and not spec.q_pool and spec.dim == spec.dim_out
                    and (glob or (h % ws == 0 and w % ws == 0 and _pow2(ws)
                                  and fbt.supported(spec.dim, spec.heads, l, n // sp))))
            if not in_z:
                out.append((grid_route(spec, h, w, dtype, int8, t_block=False), False))
            elif glob:
                out.append(("global_ref", True))
            elif train_batch is not None and fbt.save_residuals(train_batch, n // sp):
                out.append(("fused_block_t_res", True))
            else:
                out.append(("fused_block_t", True))
        if spec.q_pool:
            h, w = h // 2, w // 2
    return out


def head_bands(hw, sp: Optional[int]) -> Optional[int]:
    """The rows of each rank's band of the head's H/8 maps under a spatial
    axis of ``sp`` (models/spegnet.py), for an input of ``hw`` pixels (an int
    for a square input, or (H, W)): H / 8 / S where S divides H / 8, else
    None, and the head runs whole on every rank of the group (None too for
    no axis or S = 1).  The band at H/4, H/2 and H is 2, 4 and 8 times as
    many rows.  It holds whatever the trunk's plan (:func:`trunk_plan`): JAX
    H-shards the head under its axis at every dtype and grid."""
    h = hw if isinstance(hw, int) else hw[0]
    if sp is None or sp == 1 or (h // 8) % sp:
        return None
    return h // 8 // sp


def trunk_routes(cfg: HieraConfig, hw, dtype: torch.dtype, int8: bool,
                 train_batch: Optional[int] = None, sp: Optional[int] = None) -> List[str]:
    """The route of every block of the trunk for a patch grid ``hw`` (an int
    for a square grid, or (h, w)) in compute dtype ``dtype``:
    :func:`block_route` on the Morton path (:func:`takes_morton`),
    :func:`grid_route` elsewhere (a shape computation: nothing is
    allocated).  A route is the launch counter of its wrapper, except
    "plain" and "global_ref".  With ``train_batch``, the routes of a
    training forward of that many images: a T-block that
    ``fused_block_t.save_residuals`` sends to the saved-residual pair is
    "fused_block_t_res".  ``sp``: the size of the spatial axis when the
    config names one (:func:`trunk_plan`); the kernels' gates then see the
    local token count, as ``_save_res_ok(b, n_loc)`` does
    (spegnet_tpu/ops/fused_block_t.py:1715-1717).

    Under data parallelism each rank runs the trunk on its own rows, so
    ``train_batch`` is the batch per rank, and every route is the one of a
    single process at that batch.  JAX's gates differ there on purpose: on
    a mesh of more than one device its gen-1 block and lanes attention take
    the decomposed XLA path (``spmd_safe``, spegnet_tpu/ops/fused_block_t.py
    :162-166), where the port keeps them on their kernels per rank, as JAX's
    shard_map'd kernels see local shapes."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    if sp is not None:
        return [r for r, _ in trunk_plan(cfg, (h, w), dtype, int8, train_batch, sp)]
    morton = takes_morton(cfg, h, w, dtype)
    out, last = [], len(cfg.stages)
    for spec in block_specs(cfg):
        if morton:
            l = spec.window * spec.window if spec.window else h * w
            out.append(block_route(spec, l, h * w, spec.stage == last, int8))
        else:
            out.append(grid_route(spec, h, w, dtype, int8))
        if (train_batch is not None and out[-1] == "fused_block_t"
                and fbt.save_residuals(train_batch, h * w)):
            out[-1] = "fused_block_t_res"
        if spec.q_pool:
            h, w = h // 2, w // 2
    return out


def gathered_blocks(cfg: HieraConfig, m: int) -> List[int]:
    """The blocks whose heads a model axis of ``m`` does not divide: on the
    decomposed path their attention takes its qkv gathered over the model
    group and runs every head (Hiera-L's stage 1, 2 heads, at M = 4).  The
    kernel blocks take gathered weights whatever the heads."""
    return [i for i, sp in enumerate(block_specs(cfg)) if sp.heads % m]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The remat policy: keep the matmul outputs, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _global_sp(blk: "MultiScaleBlock", x: torch.Tensor, shard: TokenShard, approx_gelu: bool,
               remat: bool) -> torch.Tensor:
    """A global block on this rank's token shard (``fused_block_t.block_global_sp``),
    recomputed in the backward under ``remat`` as the decomposed blocks are:
    it is plain PyTorch, as JAX's in-layout XLA reference that ``nn.remat``
    wraps there."""
    def run(t):
        return fbt.block_global_sp(t, blk.block_weights(t.dtype), blk.spec.heads,
                                   blk.attn.head_dim ** -0.5, 1e-6, approx_gelu, shard)

    if not remat:
        return run(x)
    return checkpoint(run, x, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _save_dots))


def _decomposed(blk: "MultiScaleBlock", x: torch.Tensor, approx_gelu: bool, kernels: bool,
                remat: bool) -> torch.Tensor:
    """A decomposed block, recomputed in the backward under ``remat``."""
    if not remat:
        return blk(x, approx_gelu, kernels)
    return checkpoint(blk, x, approx_gelu, kernels, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _save_dots))


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


def _row_parallel(x: torch.Tensor, lin: nn.Linear, tp: ModelShard) -> torch.Tensor:
    """``lin`` on the input features of this rank's shard of its weight (x:
    those features): the product in the accumulation dtype, its partial
    sums all-reduced over the model group, the replicated bias added, one
    cast to x's dtype."""
    y = F.linear(wide(x), wide(cast(lin.weight, x.dtype)))
    return (reduce_partial(y, tp) + wide(cast(lin.bias, x.dtype))).to(x.dtype)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)
        self.tp: Optional[ModelShard] = None   # the model group (module docstring)

    @property
    def head_dim(self) -> int:
        return self.dim_out // self.num_heads

    def project(self, o: torch.Tensor) -> torch.Tensor:
        """The output projection of the full attention output ``o`` [..., C];
        under the model axis row-parallel on this rank's C / M features."""
        if self.tp is None:
            return self.proj(o)
        n = self.dim_out // self.tp.size
        return _row_parallel(o.narrow(-1, self.tp.index * n, n), self.proj, self.tp)

    def forward(self, x: torch.Tensor, kernels: bool = False) -> torch.Tensor:
        """With ``kernels`` a non-pooling attention of a supported length
        goes through ``fused_attention_lanes`` and the rest through
        ``scaled_dot_product_attention`` (the JAX package's
        ``MultiScaleAttention``, :287-315); else plain attention.  Under the
        model axis on this rank's heads where the axis divides them, every
        head of the gathered qkv where it does not (module docstring)."""
        b, h, w, _ = x.shape
        d, heads, dt = self.head_dim, self.num_heads, x.dtype
        wq, bq = cast(self.qkv.weight, dt), cast(self.qkv.bias, dt)
        local = self.tp is not None and heads % self.tp.size == 0
        if local:
            heads //= self.tp.size
        elif self.tp is not None:
            wq, bq = gather_weights([("attn.qkv.weight", wq), ("attn.qkv.bias", bq)], self.tp)
        c = heads * d
        if kernels and not self.q_pool and lanes_supported(h * w, d):
            o = fused_attention_lanes(F.linear(x.reshape(b, h * w, -1), wq, bq), heads,
                                      d ** -0.5).reshape(b, h, w, c)
        else:
            q, k, v = F.linear(x, wq, bq).reshape(b, h * w, 3, heads, d).unbind(2)
            if self.q_pool:
                q = _max_pool_2x2(q.reshape(b, h, w, -1))
                h, w = q.shape[1:3]
                q = q.reshape(b, h * w, heads, d)
            o = (scaled_dot_product_attention if kernels else attention_reference)(q, k, v)
            o = o.reshape(b, h, w, c)
        if local:
            return _row_parallel(o, self.proj, self.tp)
        return self.project(o)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList([Linear(dim, hidden), Linear(hidden, out)])
        self.tp: Optional[ModelShard] = None   # the model group (module docstring)

    def forward(self, x: torch.Tensor, approx_gelu: bool) -> torch.Tensor:
        """Under the model axis fc1 on this rank's hidden columns and fc2 on
        the matching rows, its partial sums all-reduced."""
        y = F.gelu(self.layers[0](x), approximate="tanh" if approx_gelu else "none")
        if self.tp is not None:
            return _row_parallel(y, self.layers[1], self.tp)
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

    @property
    def tp(self) -> Optional[ModelShard]:
        return self.attn.tp

    def shard_model(self, tp: Optional[ModelShard]) -> None:
        """The model group whose ranks hold this block's shards (module
        docstring); its parameters must already be the shards."""
        self.attn.tp = self.mlp.tp = tp
        self._i8_cache = None

    def train(self, mode: bool = True):
        self._i8_cache = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._i8_cache = None
        super()._load_from_state_dict(*args, **kwargs)

    # -- decomposed NHWC path ------------------------------------------------
    def forward(self, x: torch.Tensor, approx_gelu: bool,
                kernels: bool = False) -> torch.Tensor:
        """The decomposed block; ``kernels`` sends its attention through the
        kernel wrappers (:meth:`MultiScaleAttention.forward`).  Windows that
        do not divide the grid are zero-padded after norm1, so the padded
        tokens take part as keys, as in the JAX package."""
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
        x = self.attn(x, kernels)
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
    def _full(self, named, dt: torch.dtype) -> List[torch.Tensor]:
        """(name in the block, parameter) pairs cast to ``dt``; under the
        model axis the shards all-gathered into full tensors."""
        mats = [cast(p, dt) for _, p in named]
        if self.tp is None:
            return mats
        return gather_weights([(n, t) for (n, _), t in zip(named, mats)], self.tp)

    def block_weights(self, dt: torch.dtype) -> BlockWeights:
        """Matmul weights cast to the compute dtype ``dt``; norms stay f32.
        Under the model axis the full weights, gathered at each call and
        kept by nothing but the autograd graph of the block that uses
        them."""
        a, m = self.attn, self.mlp.layers
        qw, qb, pw, w1, b1, w2 = self._full(
            (("attn.qkv.weight", a.qkv.weight), ("attn.qkv.bias", a.qkv.bias),
             ("attn.proj.weight", a.proj.weight), ("mlp.layers.0.weight", m[0].weight),
             ("mlp.layers.0.bias", m[0].bias), ("mlp.layers.1.weight", m[1].weight)), dt)
        return BlockWeights(self.norm1.weight, self.norm1.bias, qw, qb, pw,
                            cast(a.proj.bias, dt), self.norm2.weight, self.norm2.bias,
                            w1, b1, w2, cast(m[1].bias, dt))

    def qpool_weights(self, dt: torch.dtype) -> QPoolWeights:
        """The transition front's weights (qkv gathered under the model axis;
        the block's own proj is replicated)."""
        a = self.attn
        qw, qb = self._full((("attn.qkv.weight", a.qkv.weight),
                             ("attn.qkv.bias", a.qkv.bias)), dt)
        return QPoolWeights(self.norm1.weight, self.norm1.bias, qw, qb,
                            cast(self.proj.weight, dt), cast(self.proj.bias, dt))

    def i8_weights(self, dt: torch.dtype):
        """The block's W8A8 weights, packed from its ``dt`` weights on first
        use and cached (outside inference mode, so a later forward with
        autograd on may read them); under the model axis packed from the
        gathered weights at each use and not kept."""
        key = (dt, self.norm1.weight.device)
        if self._i8_cache is None or self._i8_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                w = (fbt_i8.pack_qpool_i8(self.qpool_weights(dt)) if self.spec.q_pool
                     else fbt_i8.pack_i8(self.block_weights(dt)))
            if self.tp is not None:
                return w
            self._i8_cache = (key, w)
        return self._i8_cache[1]

    def forward_z(self, x: torch.Tensor, l: int, route: str,
                  approx_gelu: bool) -> torch.Tensor:
        """Non-pooling block on token-major [B, N, C] (Morton or
        window-major) with windows of l consecutive tokens, through the
        wrapper ``route`` (:func:`trunk_routes`)."""
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
        """Transition on token-major [B, N, Cin] -> [B, N/4, Cout] (each 4
        consecutive tokens one 2x2 pool group): the kernel
        front (int8 for ``route`` "qpool_front_i8"), then proj + LN2 + MLP in
        plain PyTorch (outside the TPU kernel too,
        spegnet_tpu/models/hiera.py:422-443), Megatron-style under the model
        axis."""
        a, dt = self.attn, x.dtype
        scale = a.head_dim ** -0.5
        if route == "qpool_front_i8":
            o, sc = fbt_i8.qpool_front_i8(x, self.i8_weights(dt), self.spec.heads, l, scale,
                                          1e-6)
        else:
            o, sc = qpool_front(x, self.qpool_weights(dt), self.spec.heads, l, scale, 1e-6)
        out1 = sc + a.project(o)
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
        self._sp_logged = set()   # the plans under a spatial axis already logged

    def forward(self, x: torch.Tensor, kernels: bool = True,
                dtype: torch.dtype = torch.float32, int8: bool = False,
                remat: bool = False, shard: Optional[TokenShard] = None) -> List[torch.Tensor]:
        """``remat``: recompute the decomposed blocks in the backward (module
        docstring).  ``shard``: the spatial group when the model names a
        spatial axis (its size 1 without one in the mesh); the kernel path
        then splits the Morton trunk's tokens over it (:func:`trunk_plan`),
        and every output is whole on every rank.  The plain path
        (``kernels=False``) computes the whole input on every rank."""
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError("Input spatial dims must be divisible by 32")
        approx_gelu = dtype == torch.bfloat16
        x = self.patch_embed(x.to(dtype))
        x = x + compute_pos_embed(self.pos_embed, self.pos_embed_window,
                                  x.shape[1:3]).to(dtype)
        if not kernels:
            outputs = []
            for blk in self.blocks:
                x = _decomposed(blk, x, approx_gelu, False, remat)
                if blk.spec.stage_end:
                    outputs.append(x)
            return outputs
        return self._forward_kernels(x, approx_gelu, int8, remat, shard)

    def _forward_kernels(self, x: torch.Tensor, approx_gelu: bool,
                         int8: bool = False, remat: bool = False,
                         shard: Optional[TokenShard] = None) -> List[torch.Tensor]:
        """The trunk through the wrappers of :func:`trunk_plan`.  ``lay`` is
        the window of x's window-major token layout [B, N, C] (0: raster), or
        None while x is NHWC.  The Morton path (:func:`takes_morton`) starts
        in Morton order, one window of the whole grid, which keeps every
        window of the trunk consecutive, so it never changes layout;
        elsewhere a block changes it only when its route needs windows it
        does not keep.

        Under a spatial axis above 1 a sharded block runs on x's rows
        [s N / S, (s + 1) N / S) in Morton order (``part``), rank s of the
        group: whole windows and 2x2 pool groups, so no halo.  A block that
        runs whole, each stage output and the trunk's exit all-gather the
        rows over the group (parallel/sharding.gather_tokens); the whole
        input is taken in Morton order and sliced where a sharded run
        starts."""
        _, h, w, _ = x.shape
        sp = None if shard is None else shard.size
        plan = trunk_plan(self.config, (h, w), x.dtype, int8, sp=sp)
        whole = [i for i, (_, sharded) in enumerate(plan) if not sharded]
        if sp is not None and whole and (h, w, x.dtype, int8, sp) not in self._sp_logged:
            self._sp_logged.add((h, w, x.dtype, int8, sp))
            logger.info(f"spatial axis of {sp}, grid {(h, w)}, {x.dtype}: blocks {whole} run "
                        f"whole on every rank of the spatial group, on routes "
                        f"{[plan[i][0] for i in whole]} (models/hiera.trunk_plan)")
        lay, part = None, False
        if sp is None and takes_morton(self.config, h, w, x.dtype):
            x, lay = to_z(x), h
        outputs = []
        for blk, (route, sharded) in zip(self.blocks, plan):
            sp = blk.spec
            if sharded and not part:
                if lay != h:
                    x, lay = to_z(x if lay is None else from_w(x, lay, (h, w))), h
                n = x.shape[1] // shard.size
                x, part = x[:, shard.index * n:(shard.index + 1) * n], True
            elif part and not sharded:
                x, part = gather_tokens(x, shard), False
            if route == "global_ref":
                x = _global_sp(blk, x, shard, approx_gelu, remat)
            elif route in TOKEN_ROUTES:
                if not keeps_windows(lay, sp.window):
                    x = to_w(x if lay is None else from_w(x, lay, (h, w)), sp.window)
                    lay = sp.window
                l = sp.window * sp.window if sp.window else h * w
                if sp.q_pool:
                    x = blk.forward_qpool_z(x, l, route, approx_gelu)
                    h, w, lay = h // 2, w // 2, lay // 2
                else:
                    x = blk.forward_z(x, l, route, approx_gelu)
            else:
                if lay is not None:
                    x, lay = from_w(x, lay, (h, w)), None
                x = _decomposed(blk, x, approx_gelu, True, remat)
                h, w = x.shape[1:3]
            if sp.stage_end:
                out = gather_tokens(x, shard) if part else x
                outputs.append(out if lay is None else from_w(out, lay, (h, w)))
        return outputs
