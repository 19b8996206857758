"""Main-path kernel geometries and kernel-vs-plain comparisons.

Every geometry below is one that SPEGNet inference or training with the
Hiera-L trunk hands a kernel wrapper, per image, in bf16 and (the ``F32``
tables, ``use_amp: false``) in f32: at 512^2 (the Morton
path), and at the input sizes whose patch grid is not 2^k (352^2, 384^2,
640^2, 768^2), where the T-block, the transition front and the gen-1 block
see other token counts and the decomposed blocks' attention runs
``fused_attention_lanes`` (and ``fused_attention`` at the same shapes).  A case
builds seeded random inputs and weights on a device and returns the
wrapper's call and its plain PyTorch version on the same inputs;
:func:`compare` runs both and reports the error, :func:`time_ms` times a
call with CUDA events.  A gradient case (:func:`grad_case`) does the same
for the backward: gradients of the input and of every weight through the
kernel path (the wrappers' autograd Functions) and through autograd of the
plain version, plus the two backward passes alone for timing.
:func:`compare_window` holds the window attention alone (the launcher
the T-block, the gen-1 block and the fronts share) against its plain
version at each :data:`WINDOW` geometry, its log-sum-exp included.
:func:`work` counts each call's FLOPs and bytes for its roofline bound;
:func:`tn_shapes` and :func:`tn_work` do the same for the weight-gradient
GEMM (kernels.gemm_tn) inside the backwards.  :func:`compare_gemm_f32`
holds the f32 GEMM alone at every f32 gen-1 product
(:func:`gemm_f32_shapes`), :func:`compare_lnq8` the int8 LayerNorm + quant
alone at every :data:`LNQ8` geometry.  Used by the CUDA-only tests,
chip_smoke.py and utils/gemm_tn_bench.py / gemm_bench.py.

The f32 kernels are held to :data:`F32_REL_LIMIT` against their plain f32
versions (TF32 off), and their bound is taken at :data:`PEAK_F32`.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from spegnet_tpu_torch import kernels
from spegnet_tpu_torch.ops import fused_block as fb
from spegnet_tpu_torch.ops import fused_block_i8 as fb_i8
from spegnet_tpu_torch.ops import fused_block_t as fbt
from spegnet_tpu_torch.ops import fused_block_t_i8 as fbt_i8
from spegnet_tpu_torch.ops import fused_decoder as fd
from spegnet_tpu_torch.ops import pallas_attention as pa

# name: (wrapper, C, heads, window tokens L, tokens per image); stage 4 runs
# the gen-1 entry (fused_block), the rest fused_block_t.
BLOCKS = {
    "stage1": ("fused_block_t", 144, 2, 64, 16384),
    "stage2": ("fused_block_t", 288, 4, 16, 4096),
    "stage3": ("fused_block_t", 576, 8, 256, 1024),
    "global": ("fused_block_t", 576, 8, 1024, 1024),
    "stage4": ("fused_block", 1152, 16, 64, 256),
    # grids that are not 2^k: stage 1 at 384^2 (T-block), stage 2 at 384^2
    # (gen-1, C 288 / L 16), stage 1 at 352^2 (gen-1, C 144 / L 64)
    "stage1_384": ("fused_block_t", 144, 2, 64, 9216),
    "stage2_384": ("fused_block", 288, 4, 16, 2304),
    "stage1_352": ("fused_block", 144, 2, 64, 7744),
    # the global blocks at 1024^2 (L 4096), which stay on the T-block
    "global_1024": ("fused_block_t", 576, 8, 4096, 4096),
}
# name: (Cin, Cout, heads, window tokens L at the input grid, input tokens)
QPOOL = {
    "t12": (144, 288, 4, 64, 16384),
    "t23": (288, 576, 8, 16, 4096),
    "t34": (576, 1152, 16, 256, 1024),
    "t12_384": (144, 288, 4, 64, 9216),
}
# name: (S, Cin, Cm): decoder block 2, x1 [B, S, S, Cin] -> pred [B, 2S, 2S, 1]
DECODER = {"dec2": (256, 128, 64), "dec2_384": (192, 128, 64)}
# Decoder block 2 in the int8 mode (model.int8_decoder) at 512^2, 384^2,
# 352^2 and 640^2: (S, Cin, Cm); its strip height is the TPU kernel's
# default (16 from S 256, else 8).
DEC_I8 = {"dec_i8": (256, 128, 64), "dec_i8_384": (192, 128, 64),
          "dec_i8_352": (176, 128, 64), "dec_i8_640": (320, 128, 64)}
# The edge branch at PED block 1's geometry (no model route sends a block
# there): (S, Cin, Ce, Cm), x0 [B, S, S, Cin], ef [B, S/2, S/2, Ce] ->
# [B, 2S, 2S, Cm], no head (block 1's head is its own 1x1 conv).
DEC_EDGE = {"dec_edge": (128, 256, 64, 128), "dec_edge_384": (96, 256, 64, 128)}
# The attention of the decomposed blocks, per window length L: (windows per
# image, heads, head_dim).  L 64: stage 4 at 352^2 / 384^2 (grid 11 / 12
# zero-padded to 16); L 256: stage 3 there (grid 22 / 24 padded to 32);
# L 484 / 576 / 1600 / 2304: the stage-3 global blocks at 352^2 / 384^2 /
# 640^2 / 768^2 (in f32 also 1024 / 4096 at 512^2 / 1024^2, whose bf16
# globals take the T-block).  Each bf16 L is a case of fused_attention_lanes
# ("lanes<L>", on the packed qkv) and of fused_attention ("attn<L>", on
# strided q / k / v views of the same qkv).
ATTN = {64: (4, 16, 72), 256: (4, 8, 72), 484: (1, 8, 72), 576: (1, 8, 72),
        1024: (1, 8, 72), 1600: (1, 8, 72), 2304: (1, 8, 72), 4096: (1, 8, 72)}
ATTN_CASES = {f"{kind}{l}": (wrapper, l) for l in (64, 256, 484, 576, 1600, 2304)
              for kind, wrapper in (("lanes", "fused_attention_lanes"),
                                    ("attn", "fused_attention"))}
# The window attention alone (kernels.window_attention, and
# kernels.qpool_attention where pooled), at every geometry the T-block, the
# gen-1 block (stage 4) and the fronts hand it per image in a 512^2 forward,
# the 1024^2 global block (L 4096), and head dims past Hiera-L's 72 at every
# work mode of kernels.window_plan; name: (heads, head_dim, key window Lk,
# pooled, key rows per image).  Pooled: query windows of Lk / 4 rows.
WINDOW = {"stage1": (2, 72, 64, False, 16384), "stage2": (4, 72, 16, False, 4096),
          "stage3": (8, 72, 256, False, 1024), "global": (8, 72, 1024, False, 1024),
          "stage4": (16, 72, 64, False, 256), "t12": (4, 72, 64, True, 16384),
          "t23": (8, 72, 16, True, 4096), "t34": (16, 72, 256, True, 1024),
          "global_1024": (8, 72, 4096, False, 4096), "d96": (4, 96, 256, False, 1024),
          "d128": (4, 128, 16, True, 1024), "d256": (2, 256, 256, True, 1024),
          "d256_global": (2, 256, 1024, False, 1024), "d256_l16": (2, 256, 16, False, 1024)}
# The window attention's log-sum-exp (log2 units) against the plain one,
# max abs difference: f32 sums of the same bf16 products in another order
# and the SFU's exp2 (2^-22 relative) on values of a few units at most;
# a wrong window or tile would be off by O(1).
LSE_ABS_LIMIT = 1e-3
# The int8 encoder's geometries (model.int8_encoder): each bf16 geometry the
# int8 gates take, as (bf16 geometry, int8 wrapper).
I8 = {"stage2_i8": ("stage2", "fused_block_t_i8"), "stage3_i8": ("stage3", "fused_block_t_i8"),
      "global_i8": ("global", "fused_block_t_i8"), "stage4_i8": ("stage4", "fused_block_i8"),
      "t23_i8": ("t23", "qpool_front_i8"), "t34_i8": ("t34", "qpool_front_i8")}

# f32 compute: the gen-1 block at every f32 main-path geometry of Hiera-L
# 512^2 (stage 1, stage 2, stage 4; in f32 JAX takes no T-block, so the
# gen-1 block carries stages 1-2 too), name: (C, heads, window tokens L,
# tokens per image); the attention kernel at every f32 lanes length
# (stage 3 at L 256, the global blocks at 484 / 576 / 1024 / 1600 / 4096 at
# 352^2 / 384^2 / 512^2 / 640^2 / 1024^2, stage 4 of 352^2 / 384^2 at 64) for
# fused_attention_lanes, and at 512^2's lengths for fused_attention; and the
# int8 gen-1 block on f32 at stage 4 (``int8_encoder``).
F32_BLOCKS = {"stage1_f32": (144, 2, 64, 16384), "stage2_f32": (288, 4, 16, 4096),
              "stage4_f32": (1152, 16, 64, 256)}
F32_ATTN_CASES = {f"lanes{l}_f32": ("fused_attention_lanes", l)
                  for l in (64, 256, 484, 576, 1024, 1600, 4096)}
F32_ATTN_CASES.update({f"attn{l}_f32": ("fused_attention", l) for l in (64, 256, 1024)})
F32_I8 = {"stage4_i8_f32": "stage4_f32"}
# Blocks of each f32 geometry in one Hiera-L forward at 512^2.
COUNT_F32 = {"stage1_f32": 2, "stage2_f32": 5, "stage4_f32": 3, "lanes256_f32": 32,
             "lanes1024_f32": 3, "attn256_f32": 32, "attn1024_f32": 3, "stage4_i8_f32": 3}

# The weight-gradient GEMM (kernels.gemm_tn, csrc/hiera_block_bwd.cu) in the
# kernel backwards of one Hiera-L training step at 512^2: the T-block's four
# (#5, and #6 under SPEGNET_SAVE_RESIDUALS) at stages 1-3 and the global
# blocks, the transition fronts' one (#4: the qkv and shortcut projections
# together) and the gen-1 block's four at stage 4 (#7's backward); name:
# (block geometry, N, K as multiples of C (or of Cout, Cin for a front)),
# M = batch x tokens.
TN_PRODUCTS = {"qkv": (3, 1), "proj": (1, 1), "fc1": (4, 1), "fc2": (1, 4)}
TN_GEOMS = ("stage1", "stage2", "stage3", "global", "stage4", "t12", "t23", "t34")


def tn_shapes(batch: int) -> Dict[str, Tuple[int, int, int]]:
    """name -> (M, N, K) of each weight gradient of :data:`TN_GEOMS`."""
    out = {}
    for geo in TN_GEOMS:
        if geo in QPOOL:
            cin, cout, _, _, n = QPOOL[geo]
            out[f"{geo}_qkv_sc"] = (batch * n, 4 * cout, cin)
            continue
        _, c, _, _, n = BLOCKS[geo]
        for prod, (fn, fk) in TN_PRODUCTS.items():
            out[f"{geo}_{prod}"] = (batch * n, fn * c, fk * c)
    return out


def tn_work(m: int, n: int, k: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one gemm_tn call: 2 M N K, the bf16 operands read
    once and the f32 gradient and column sums written once."""
    return 2.0 * m * n * k, 2.0 * m * (n + k) + 4.0 * n * (k + 1)


# The forward GEMMs (kernels.gemm in bf16, kernels.gemm_i8 in int8) of one
# Hiera-L forward at 512^2: each block geometry's four projections with their
# epilogues (the T-block's at stages 1-3 and the global blocks, #1 / #10;
# the gen-1 block's at stage 4, #7 / #12) and each transition front's
# stacked qkv + shortcut product (#3 / #11).  name: (block geometry, N, K as
# multiples of C (of Cout, Cin for a front), GELU, residual).
GEMM_PRODUCTS = {"qkv": (3, 1, False, False), "proj": (1, 1, False, True),
                 "fc1": (4, 1, True, False), "fc2": (1, 4, False, True)}
# Blocks or fronts of each geometry per forward (stage 3 with the three
# global blocks, which have its shapes), bf16 and with ``int8_encoder``
# (stage 1 and t12 stay bf16 there, as JAX's int8 gates send them).
GEMM_COUNT = {"stage1": 2, "stage2": 5, "stage3": 35, "stage4": 3, "t12": 1, "t23": 1,
              "t34": 1}
GEMM_I8_GEOMS = ("stage2", "stage3", "stage4", "t23", "t34")


def gemm_shapes(batch: int) -> Dict[str, Tuple[int, int, int, bool, bool]]:
    """name -> (M, N, K, GELU, residual) of each forward GEMM of
    :data:`GEMM_COUNT`'s geometries."""
    out = {}
    for geo in GEMM_COUNT:
        if geo in QPOOL:
            cin, cout, _, _, n = QPOOL[geo]
            out[f"{geo}_qkv_sc"] = (batch * n, 4 * cout, cin, False, False)
            continue
        _, c, _, _, n = BLOCKS[geo]
        for prod, (fn, fk, gelu, res) in GEMM_PRODUCTS.items():
            out[f"{geo}_{prod}"] = (batch * n, fn * c, fk * c, gelu, res)
    return out


def gemm_work(m: int, n: int, k: int, int8: bool = False, residual: bool = False,
              out_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one forward GEMM: 2 M N K; the operands read
    once (bf16, or int8 codes with f32 row scales), the bias (bf16, or f32
    in int8) and a residual read once, the output written once."""
    if int8:
        nbytes = m * k + n * k + 4.0 * (m + n) + 4.0 * n
    else:
        nbytes = 2.0 * (m * k + n * k) + 2.0 * n
    return 2.0 * m * n * k, nbytes + out_bytes * m * n * (2 if residual else 1)


# The hand-off GEMM (csrc/gemm_handoff.cuh): every product of a 512^2
# forward that kernels.gemm_plan sends it (each stage's fc1 with its GELU,
# and with the GELU-pre epilogue of the backward's recompute; the fronts'
# stacked qkv + shortcut product with its bias), and ragged shapes (M, N, K
# tails, an odd M-tile count, N not a multiple of 192).  name: (M at batch
# 1, N, K, epilogue); M scales with the batch but in the ragged cases.
GEMM_HO = {**{f"stage{s + 1}_fc1{ep}": ((128 >> s) ** 2, 4 * (144 << s), 144 << s, act)
              for s in range(4) for ep, act in (("", "gelu"), ("_pre", "gelu_pre"))},
           "t12_qkv_sc": (16384, 1152, 144, "none"), "t23_qkv_sc": (4096, 2304, 288, "none"),
           "t34_qkv_sc": (1024, 4608, 576, "none"),
           "ragged_gelu": (4099, 1160, 200, "gelu"), "ragged_pre": (4099, 1160, 72, "gelu_pre"),
           "ragged_odd": (17000, 384, 72, "gelu"),
           "ragged_none": (33001, 2304, 200, "none")}


def gemm_ho_shape(name: str, batch: int) -> Tuple[int, int, int, str]:
    """(M, N, K, epilogue) of :data:`GEMM_HO` case ``name`` at ``batch``."""
    m, n, k, act = GEMM_HO[name]
    return (m if name.startswith("ragged") else batch * m), n, k, act


def gemm_ho_calls(name: str, batch: int, g, device, mod=None):
    """(kernel call, plain call, torch.mm call) of :data:`GEMM_HO` case
    ``name`` on seeded bf16 operands (weights scaled by K^-1/2):
    kernels.gemm / gemm_gelu_pre (of ``mod``, another tree's kernels
    module, if given), kernels.gemm_plain, and torch.mm of the operands (a
    yardstick)."""
    m, n, k, act = gemm_ho_shape(name, batch)
    a = torch.randn((m, k), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((n, k), generator=g) * k ** -0.5).to(device, torch.bfloat16)
    b = (0.1 * torch.randn((n,), generator=g)).to(device, torch.bfloat16)
    mod = mod or kernels
    mm = lambda: torch.mm(a, w.t())  # noqa: E731
    if act == "gelu_pre":
        return (lambda: mod.gemm_gelu_pre(a, w, b),
                lambda: kernels.gemm_plain(a, w, b, pre=True), mm)
    return (lambda: mod.gemm(a, w, b, gelu=act == "gelu"),
            lambda: kernels.gemm_plain(a, w, b, gelu=act == "gelu"), mm)


def compare_gemm_ho(name: str, batch: int, g, device) -> Dict[str, object]:
    """The hand-off GEMM at case ``name`` against its plain version: max |k
    - p| and max |k - p| / max |p| over its outputs, whether the plan sent
    the product to the hand-off kernel, and whether two calls gave the same
    bits."""
    kern, plain, _ = gemm_ho_calls(name, batch, g, device)
    m, n, k, _ = gemm_ho_shape(name, batch)
    sms = kernels._sm_count(device.index or 0)
    routed = kernels.gemm_plan(m, n, k, sms).handoff
    before = kernels.gemm_launches["gemm_handoff"]
    got, again, want = kern(), kern(), plain()
    launched = kernels.gemm_launches["gemm_handoff"] - before
    got, again, want = (t if isinstance(t, tuple) else (t,) for t in (got, again, want))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    peak = max(float(y.float().abs().max()) for y in want)
    return {"max_abs": err, "rel": err / peak, "routed": routed, "launched": launched,
            "same": all(torch.equal(x, y) for x, y in zip(got, again))}


def gemm_ho_ok(res: Dict[str, object]) -> bool:
    """Within REL_LIMIT, two calls bit-equal, and the product went to the
    hand-off kernel, twice."""
    return res["rel"] <= REL_LIMIT and res["same"] and res["routed"] and res["launched"] == 2


# The f32 GEMM (kernels.gemm_f32, the 3xTF32 form of
# csrc/gemm_persistent.cuh) at every product of the f32 gen-1 blocks (#7 at
# f32): the four projections of each :data:`F32_BLOCKS` geometry (512^2) and
# of the 384^2 f32 gen-1 blocks (stages 1 and 2 there, 2 and 5 blocks);
# name: (C, tokens per image, blocks per forward); and a shape with M, N and
# K tails.
F32_GEMM_GEOMS = {**{n: (c, t, COUNT_F32[n]) for n, (c, _, _, t) in F32_BLOCKS.items()},
                  "stage1_384_f32": (144, 9216, 2), "stage2_384_f32": (288, 2304, 5)}
F32_GEMM_PRODUCTS = {"qkv": (3, 1, None, False), "proj": (1, 1, None, True),
                     "fc1": (4, 1, "erf", False), "fc2": (1, 4, None, True)}
F32_GEMM_RAGGED = (300, 200, 100)


def gemm_f32_shapes(batch: int) -> Dict[str, Tuple[int, int, int, Optional[str], bool]]:
    """name -> (M, N, K, GELU, residual) of each f32 GEMM of
    :data:`F32_GEMM_GEOMS` with its epilogue, and ``ragged``
    (:data:`F32_GEMM_RAGGED`, erf GELU and residual)."""
    out = {}
    for geo, (c, n, _) in F32_GEMM_GEOMS.items():
        for prod, (fn, fk, gelu, res) in F32_GEMM_PRODUCTS.items():
            out[f"{geo}_{prod}"] = (batch * n, fn * c, fk * c, gelu, res)
    m, n, k = F32_GEMM_RAGGED
    out["ragged"] = (m, n, k, "erf", True)
    return out


def gemm_f32_work(m: int, n: int, k: int, residual: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one f32 GEMM: 2 M N K; the f32 operands and bias
    read once, a residual read once, the output written once."""
    return 2.0 * m * n * k, 4.0 * (m * k + n * k + n) + 4.0 * m * n * (2 if residual else 1)


def gemm_f32_calls(name: str, batch: int, g, device):
    """(kernel call, plain call, F.linear call) of f32 GEMM ``name`` of
    :func:`gemm_f32_shapes` on seeded f32 operands (weights scaled by K^-1/2,
    as an nn.Linear's): kernels.gemm_f32 with the epilogue; its plain f32
    version (F.linear, the GELU, + residual, as ``block_reference``
    computes them; TF32 off); and the product alone by F.linear, the one
    PyTorch call that computes it."""
    m, n, k, gelu, res = gemm_f32_shapes(batch)[name]
    a = torch.randn((m, k), generator=g).to(device)
    w = (torch.randn((n, k), generator=g) * k ** -0.5).to(device)
    bias = (0.1 * torch.randn((n,), generator=g)).to(device)
    r = torch.randn((m, n), generator=g).to(device) if res else None

    def plain():
        y = F.linear(a, w, bias)
        if gelu:
            y = F.gelu(y, approximate="tanh" if gelu == "tanh" else "none")
        return y if r is None else r + y

    return (lambda: kernels.gemm_f32(a, w, bias, residual=r, gelu=gelu), plain,
            lambda: F.linear(a, w, bias))


def compare_gemm_f32(name: str, batch: int, g, device) -> Dict[str, object]:
    """The f32 GEMM ``name`` against its plain f32 version: max |k - p| /
    max |p| (``rel``, the limit :data:`F32_REL_LIMIT`) and two calls
    bit-equal (``same``)."""
    kern, plain, _ = gemm_f32_calls(name, batch, g, device)
    got, again, want = kern(), kern(), plain()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: f32 GEMM output is not finite")
    return {"rel": float((got - want).abs().max() / want.abs().max().clamp_min(1e-12)),
            "same": torch.equal(got, again)}


def gemm_f32_ok(res: Dict[str, object]) -> bool:
    return res["rel"] <= F32_REL_LIMIT and bool(res["same"])


# LayerNorm + quant (kernels.layernorm_q8, csrc/int8_gemm.cu) in one int8
# forward at 512^2 (``int8_encoder``): LN1 / LN2 of the int8 T-blocks at
# stage 2 and the t23 front's LayerNorm (C 288), of stage 3, the global
# blocks and the t34 front (C 576), of the int8 gen-1 blocks at stage 4
# (C 1152); the last also in an f32 int8 forward.  name: (C, rows per image,
# f32, calls per forward).
LNQ8 = {"stage2": (288, 4096, False, 11), "stage3": (576, 1024, False, 71),
        "stage4": (1152, 256, False, 6), "stage4_f32": (1152, 256, True, 6)}


def lnq8_bytes(name: str, batch: int) -> float:
    """Bytes one layernorm_q8 call of ``name`` must move: each row read once
    (bf16 or f32), its codes and scale written once, the LayerNorm weight and
    bias read once."""
    c, n, f32, _ = LNQ8[name]
    m = batch * n
    return m * c * (4 if f32 else 2) + m * c + 4.0 * m + 8.0 * c


def lnq8_inputs(name: str, batch: int, g, device):
    """(x, weight, bias) of ``name`` on seeded values (weight ~1 + 0.1 N,
    bias 0.1 N, as :func:`block_weights`'s LayerNorms)."""
    c, n, f32, _ = LNQ8[name]
    x = torch.randn((batch * n, c), generator=g).to(device,
                                                     torch.float32 if f32 else torch.bfloat16)
    return (x, _v((c,), g, device, 0.1, torch.float32, 1.0),
            _v((c,), g, device, 0.1, torch.float32))


def compare_lnq8(name: str, batch: int, g, device) -> Dict[str, object]:
    """kernels.layernorm_q8 at ``name`` against its plain version
    (``quant_tokens(layer_norm(x))``): the share of codes that differ, the
    largest code difference, the scales that differ and their largest
    relative difference, and two calls bit-equal."""
    x, w, b = lnq8_inputs(name, batch, g, device)
    q, s = kernels.layernorm_q8(x, w, b, 1e-6)
    q2, s2 = kernels.layernorm_q8(x, w, b, 1e-6)
    qp, sp = fbt_i8.quant_tokens(fbt.layer_norm(x, w, b, 1e-6))
    dq = (q.int() - qp.int()).abs()
    return {"code_frac": (dq > 0).float().mean().item(), "code_max": int(dq.max().item()),
            "scale_differ": int((s != sp[:, 0]).sum().item()),
            "scale_rel": ((s - sp[:, 0]).abs() / sp[:, 0]).max().item(),
            "same": torch.equal(q, q2) and torch.equal(s, s2)}


# A LayerNorm + quant row scale against plain, relative: bf16 rows round
# the LayerNorm output to bf16, so the absmax and the scale are equal unless
# the absmax element rounds across a bf16 edge (one step, 2^-8); f32 rows
# keep the output's last bits, which the mean and the variance summed in
# another order and rsqrt's rounding move by a few ulps (the scale within
# 2.4e-7 on an H100 before the row pass was redesigned): 8 ulps.
LNQ8_SCALE_REL = {False: 2.0 ** -8, True: 2.0 ** -20}


def lnq8_ok(res: Dict[str, object], f32: bool) -> bool:
    """The int8 rule on LayerNorm + quant: codes equal or one code apart on
    at most :data:`I8_PART_FRAC` of them, scales within
    :data:`LNQ8_SCALE_REL`, two calls bit-equal."""
    return (res["code_frac"] <= I8_PART_FRAC and res["code_max"] <= 1
            and res["scale_rel"] <= LNQ8_SCALE_REL[f32] and bool(res["same"]))


# The LayerNorm backward (kernels.layernorm_bwd) at each C of a 512^2
# training step: name: (C, rows per image, calls per step with dres,
# without).  LN1 and LN2 of every block backward (#5 / #6 / #7, with dres:
# 2 blocks at C 144, 5 at 288, 35 at 576 (stage 3 and the global blocks),
# 3 at 1152) and LN1 of each front (#4, without: t12, t23, t34).
LN_BWD = {"stage1": (144, 16384, 4, 1), "stage2": (288, 4096, 10, 1),
          "stage3": (576, 1024, 70, 1), "stage4": (1152, 256, 6, 0)}


def ln_bwd_inputs(name: str, batch: int, g, device):
    """(x, weight, dy, dres) of ``name``: rows N(0, 1) plus a per-row offset,
    weight ~1 + 0.1 N, dy and dres N(0, 1)."""
    c, n, _, _ = LN_BWD[name]
    m = batch * n
    x = (torch.randn((m, c), generator=g) + torch.randn((m, 1), generator=g)).to(
        device, torch.bfloat16)
    return (x, _v((c,), g, device, 0.1, torch.float32, 1.0),
            _v((m, c), g, device, 1.0), _v((m, c), g, device, 1.0))


def ln_bwd_bytes(name: str, batch: int, dres: bool) -> float:
    """Bytes one call must move: x, dy (and dres) read once, dx written once
    (bf16), the weight read and dw, db written once (f32)."""
    c, n, _, _ = LN_BWD[name]
    return (6.0 + 2 * dres) * batch * n * c + 12.0 * c


def compare_ln_bwd(name: str, batch: int, dres: bool, g, device) -> Dict[str, object]:
    """kernels.layernorm_bwd at ``name`` against its plain version
    (ops/fused_block_t._layer_norm_bwd in f32 on the same bf16 rows, + dres):
    max|k - p| / max|p| of dx, dw and db, and two calls bit-equal."""
    x, w, dy, dr = ln_bwd_inputs(name, batch, g, device)
    dr = dr if dres else None
    got = kernels.layernorm_bwd(x, w, dy, 1e-6, dres=dr)
    again = kernels.layernorm_bwd(x, w, dy, 1e-6, dres=dr)
    dxp, dwp, dbp = fbt._layer_norm_bwd(x, w, dy.float(), 1e-6)
    if dr is not None:
        dxp = dxp + dr.float()
    out = {k: _rel(a, b)[1] for k, a, b in zip(("dx", "dw", "db"), got, (dxp, dwp, dbp))}
    out["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
    out["same"] = all(torch.equal(a, b) for a, b in zip(got, again))
    return out


def ln_bwd_ok(res: Dict[str, object]) -> bool:
    """dx, dw and db within :data:`BWD_REL_LIMIT`, finite, two calls
    bit-equal."""
    return (bool(res["finite"]) and bool(res["same"])
            and max(res["dx"], res["dw"], res["db"]) <= BWD_REL_LIMIT)


# The T-block's saved-residual pair (training under SPEGNET_SAVE_RESIDUALS)
# at its 512^2 geometries.
RES = ("stage1", "stage2", "stage3", "global")

# Blocks of each geometry in one Hiera-L forward at 512^2 (for per-forward
# totals), and at 384^2 (fused_attention takes the geometries of
# fused_attention_lanes there: its time per forward is what it would take
# in their place).
BLOCK_COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3,
               "t12": 1, "t23": 1, "t34": 1, "dec2": 1, "dec_i8": 1, "dec_edge": 1}
BLOCK_COUNT.update({n: BLOCK_COUNT[g] for n, (g, _) in I8.items()})
COUNT_384 = {"stage1_384": 2, "t12_384": 1, "stage2_384": 5, "dec2_384": 1, "dec_i8_384": 1,
             "lanes64": 3, "lanes256": 32, "lanes576": 3, "attn64": 3, "attn256": 32,
             "attn576": 3}

# Kernel-vs-plain limit on max|kernel - plain| / max|plain| in bf16: the two
# round at different points (GELU before vs after the bf16 cast, softmax
# normalized after vs before P.V, f32 vs bf16 BN), a few bf16 ulps (2^-8
# relative) of the largest output.
REL_LIMIT = 2e-2
# Kernel backward vs bf16 autograd of the plain version, same measure: the
# two round their bf16 intermediates (dS, dqkv, dh) at different points and
# sum f32 weight gradients in different orders.  Measured on an H100 at
# batch 2: at most 1.01e-2 (dx of stage 3); the limit keeps 2.5x of that.
BWD_REL_LIMIT = 2.5e-2

# An int8 block or front vs its plain int8 version, in bf16: REL_LIMIT and
# no element more than one dequant step (0.2) apart.  The JAX package's
# element rule (tests/test_int8_block.py:56-61: <1% of elements more than
# 5e-4 apart) holds in f32 on the CPU (tests/test_torch_int8.py) but not
# here: the bf16 attention of the kernel and of the plain version round P
# at different points, which moves some attention outputs by one bf16 step
# and their int8 codes by one across a rounding edge (measured on an H100:
# 64% of the global block's outputs beyond 5e-4, max 0.0625, rel 1.1e-2).
# The share beyond 5e-4 is printed; the int8 pieces are held exactly by
# :func:`i8_parts`.
I8_ATOL, I8_MAX = 5e-4, 0.2
# i8_parts limits: LayerNorm + quant codes (the kernel's rsqrtf vs torch's
# rsqrt may move a LayerNorm output across a bf16 rounding edge, and its
# code by one) and the GELU epilogue (tanhf vs torch's tanh may move an
# output across a bf16 rounding edge): share of elements that differ, and
# by at most one code / one bf16 step.  Row quant and the GEMM without GELU
# must be bit-exact.
I8_PART_FRAC = 1e-3

# An f32 kernel vs its plain f32 version (TF32 off), same measure: both
# compute in f32 (the kernels' products 3xTF32, ~f32), summing in other
# orders; a few hundred f32 ulps (2^-24) of the largest output.
F32_REL_LIMIT = 2e-5
# The int8 gen-1 block on f32 vs its plain int8 version: the int8 rule
# (i8_ok, i8_parts_ok); its GELU epilogue (erff vs torch's erf) within
# I8_F32_GELU_REL of the largest output, a few f32 ulps.
I8_F32_GELU_REL = 1e-6

# The H100 SXM's dense bf16 and int8 tensor-core rates and HBM bandwidth
# (data sheet), for the roofline bound of each call; PEAK_F32 is the rate of
# the card's fastest f32-accurate product, 3xTF32 on the dense 495 TFLOP/s
# TF32 rate (three products per multiply-add), the f32 kernels' bound.
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_F32 = 495e12 / 3


class Case(NamedTuple):
    wrapper: str
    kernel: Callable[[], object]
    plain: Callable[[], object]


def _w(shape, fan_in, g, device, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g) * fan_in ** -0.5).to(device, dtype)


def _v(shape, g, device, scale=0.02, dtype=torch.bfloat16, offset=0.0):
    return (offset + scale * torch.randn(shape, generator=g)).to(device, dtype)


def block_weights(c: int, heads: int, g, device, dtype=torch.bfloat16) -> fbt.BlockWeights:
    """Seeded random block weights, matmul weights in ``dtype``."""
    f32 = torch.float32
    return fbt.BlockWeights(
        _v((c,), g, device, 0.1, f32, 1.0), _v((c,), g, device, 0.1, f32),
        _w((3 * c, c), c, g, device, dtype), _v((3 * c,), g, device, dtype=dtype),
        _w((c, c), c, g, device, dtype), _v((c,), g, device, dtype=dtype),
        _v((c,), g, device, 0.1, f32, 1.0), _v((c,), g, device, 0.1, f32),
        _w((4 * c, c), c, g, device, dtype), _v((4 * c,), g, device, dtype=dtype),
        _w((c, 4 * c), 4 * c, g, device, dtype), _v((c,), g, device, dtype=dtype))


def block_case(name: str, batch: int, g, device) -> Case:
    wrapper, c, heads, l, n = BLOCKS[name]
    wts = block_weights(c, heads, g, device)
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block":
        xw = x.reshape(batch * n // l, l, c)
        return Case(wrapper, lambda: fb.fused_block(xw, wts, heads, scale),
                    lambda: fb.block_reference(xw, wts, heads, scale))
    return Case(wrapper, lambda: fbt.fused_block_t(x, wts, heads, l, scale),
                lambda: fbt.block_plain(x, wts, heads, l, scale))


def f32_block_case(name: str, batch: int, g, device) -> Case:
    """The f32 gen-1 block at geometry ``name`` of :data:`F32_BLOCKS`, with
    the erf GELU of f32 compute."""
    c, heads, l, n = F32_BLOCKS[name]
    wts = block_weights(c, heads, g, device, torch.float32)
    xw = torch.randn((batch * n // l, l, c), generator=g).to(device)
    scale = (c // heads) ** -0.5
    return Case("fused_block", lambda: fb.fused_block(xw, wts, heads, scale, approx_gelu=False),
                lambda: fb.block_reference(xw, wts, heads, scale, approx_gelu=False))


def f32_attention_case(name: str, batch: int, g, device) -> Case:
    """An f32 attention geometry of :data:`F32_ATTN_CASES` on seeded random
    qkv."""
    wrapper, l = F32_ATTN_CASES[name]
    return _attention_case(wrapper, l, batch, g, device, torch.float32)


def f32_i8_case(name: str, batch: int, g, device) -> Case:
    """The int8 gen-1 block on f32 (f32 weights packed to W8A8, erf GELU)
    through the wrapper and its plain int8 version."""
    c, heads, l, n = F32_BLOCKS[F32_I8[name]]
    wts = fbt_i8.pack_i8(block_weights(c, heads, g, device, torch.float32))
    xw = torch.randn((batch * n // l, l, c), generator=g).to(device)
    scale = (c // heads) ** -0.5
    return Case("fused_block_i8",
                lambda: fb_i8.fused_block_i8(xw, wts, heads, scale, approx_gelu=False),
                lambda: fb_i8.block_i8_plain(xw, wts, heads, scale, approx_gelu=False))


def qpool_case(name: str, batch: int, g, device) -> Case:
    cin, cout, heads, l, n = QPOOL[name]
    wts = qpool_weights(cin, cout, g, device)
    x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
    scale = (cout // heads) ** -0.5
    return Case("qpool_front", lambda: fbt.qpool_front(x, wts, heads, l, scale),
                lambda: fbt.qpool_front_plain(x, wts, heads, l, scale))


def decoder_case(name: str, batch: int, g, device) -> Case:
    return decoder_case_at(*DECODER[name], batch, g, device)


def decoder_params(cin: int, cm: int, g, device, ce: int = 0,
                   head: bool = True) -> fd.DecoderParams:
    """Seeded random decoder-block parameters (bf16 convs, f32 BN)."""
    f32 = torch.float32

    def bn():
        return (_v((cm,), g, device, 0.2, f32, 1.0), _v((cm,), g, device, 0.1, f32),
                _v((cm,), g, device, 0.1, f32), _v((cm,), g, device, 0.2, f32, 1.0).abs(),
                1e-5)

    p = fd.DecoderParams(_w((cm, cin, 3, 3), 9 * (cin + ce), g, device), _v((cm,), g, device),
                         bn(), _w((cm, cm, 3, 3), 9 * cm, g, device), _v((cm,), g, device),
                         bn(), _w((1, cm, 1, 1), cm, g, device), _v((1,), g, device))
    if ce:
        p = p._replace(we=_w((cm, ce, 3, 3), 9 * (cin + ce), g, device))
    if not head:
        p = p._replace(head_w=None, head_b=None)
    return p


def decoder_case_at(s: int, cin: int, cm: int, batch: int, g, device) -> Case:
    """Decoder block 2 on x [batch, s, s, cin] with cm channels."""
    p = decoder_params(cin, cm, g, device)
    x = torch.randn((batch, s, s, cin), generator=g).to(device, torch.bfloat16)
    return Case("fused_decoder_block", lambda: fd.fused_decoder_block(x, p),
                lambda: fd.decoder_block_plain(x, p))


def edge_case(name: str, batch: int, g, device, head: bool = False) -> Case:
    """The bf16 block with its edge branch at geometry ``name`` of
    :data:`DEC_EDGE` (or a small one passed as a tuple)."""
    s, cin, ce, cm = DEC_EDGE[name] if isinstance(name, str) else name
    p = decoder_params(cin, cm, g, device, ce=ce, head=head)
    x = torch.randn((batch, s, s, cin), generator=g).to(device, torch.bfloat16)
    ef = torch.randn((batch, s // 2, s // 2, ce), generator=g).to(device, torch.bfloat16)
    return Case("fused_decoder_block_edge", lambda: fd.fused_decoder_block(x, p, ef),
                lambda: fd.decoder_block_plain(x, p, ef))


def dec_i8_inputs(name, batch: int, g, device):
    """(x, packed int8 weights, bf16 parameters) of int8 decoder geometry
    ``name`` of :data:`DEC_I8` (or (S, Cin, Cm) given)."""
    s, cin, cm = DEC_I8[name] if isinstance(name, str) else name
    p = decoder_params(cin, cm, g, device)
    x = torch.randn((batch, s, s, cin), generator=g).to(device, torch.bfloat16)
    return x, fd.pack_i8(p), p


def dec_i8_case(name, batch: int, g, device) -> Case:
    """Decoder block 2 in the int8 mode through the wrapper and through its
    plain int8 version, on the same packed weights."""
    x, q, p = dec_i8_inputs(name, batch, g, device)
    return Case("fused_decoder_block_i8",
                lambda: fd.fused_decoder_block(x, p, int8=True, q=q),
                lambda: fd.decoder_block_i8_plain(x, q))


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    """(share of elements that differ, largest difference in bf16 steps of
    |want|) of two bf16-valued tensors."""
    got, want = got.float(), want.float()
    differ = got != want
    _, e = torch.frexp(torch.where(want == 0, torch.ones_like(want), want))
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    steps = ((got - want).abs() / ulp)[differ].max().item() if differ.any() else 0.0
    return differ.float().mean().item(), steps


def dec_bf16_parts(name, batch: int, g, device) -> Dict[str, float]:
    """Decoder block 2's bf16 kernels one by one at geometry ``name`` of
    :data:`DEC_I8` (or (S, Cin, Cm) given): conv1 (``kernels.dec_upconv``)
    against the plain version's activated conv1 map, and conv2 + head
    (``kernels.dec_conv_head``) on that plain map against the plain logits,
    each as max |difference| / max |plain|; and whether two calls of each
    give the same bits."""
    from spegnet_tpu_torch.ops.fused_upsample_conv import upsample2x_conv3x3

    s, cin, cm = DEC_I8[name] if isinstance(name, str) else name
    p = decoder_params(cin, cm, g, device)
    x = torch.randn((batch, s, s, cin), generator=g).to(device, torch.bfloat16)
    s1, t1 = (v.contiguous() for v in fd.fold_bn(p.b1, *p.bn1))
    s2, t2 = (v.contiguous() for v in fd.fold_bn(p.b2, *p.bn2))
    wt1, wt2 = fd._pack_conv_t(p.w1.to(x.dtype)), fd._pack_conv_t(p.w2.to(x.dtype))
    hw, hb = p.head_w.reshape(-1).float().contiguous(), p.head_b.reshape(-1).float().contiguous()
    y1 = kernels.dec_upconv(x, wt1, s1, t1)
    y1_plain = fd._bn_relu(upsample2x_conv3x3(x.permute(0, 3, 1, 2), p.w1.to(x.dtype)), s1, t1)
    y1_plain = y1_plain.permute(0, 2, 3, 1).contiguous()
    pred = kernels.dec_conv_head(y1_plain, wt2, s2, t2, hw, hb)
    pred_plain = fd.decoder_block_plain(x, p)[..., 0]

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    return {"y1_rel": rel(y1, y1_plain), "pred_rel": rel(pred, pred_plain),
            "y1_same": bool(torch.equal(y1, kernels.dec_upconv(x, wt1, s1, t1))),
            "pred_same": bool(torch.equal(pred, kernels.dec_conv_head(y1_plain, wt2, s2, t2,
                                                                      hw, hb)))}


def dec_bf16_parts_ok(res: Dict[str, float]) -> bool:
    """Each bf16 decoder kernel within REL_LIMIT of plain, two calls
    bit-equal."""
    return (res["y1_rel"] <= REL_LIMIT and res["pred_rel"] <= REL_LIMIT and res["y1_same"]
            and res["pred_same"])


def strips_apart(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """Border strips [4, B, 2S, Cm] against their plain version: the share
    of elements that differ and the largest difference in bf16 steps, an
    element's step being that of max(|want|, peak / 256), peak the largest
    |want| of its strip, image and channel.  Two f32 sums of the same bf16
    products in another order differ by the rounding of their large terms,
    which is many bf16 steps of a sum that cancels to near zero; measured
    against 1/256 of the strip's peak it is at most one."""
    got, want = got.float(), want.float()
    differ = got != want
    peak = want.abs().amax(dim=2, keepdim=True)
    ref = torch.maximum(want.abs(), peak / 256)
    _, e = torch.frexp(torch.where(ref == 0, torch.ones_like(ref), ref))
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    steps = ((got - want).abs() / ulp)[differ].max().item() if differ.any() else 0.0
    return {"frac": differ.float().mean().item(), "steps": steps}


def strips_ok(res: Dict[str, float]) -> bool:
    """The int8-piece rule for the strips (:func:`strips_apart`): equal, or
    one step apart on at most I8_PART_FRAC of the elements."""
    return res["frac"] <= I8_PART_FRAC and res["steps"] <= 1.0


def dec_i8_parts(name, batch: int, g, device) -> Dict[str, float]:
    """The int8 decoder's pieces through the kernels against the plain int8
    version on the same input and weights, the kernel chain given
    ``make_strips``' strips (as the plain version takes them): the x codes
    (share that differ, largest code difference) and scales (how many
    differ), the per-strip scales (how many differ, all strips), conv1's
    activated map after the border paste and the logits (share of bf16
    values that differ, largest difference in bf16 steps), and conv2's
    activated map and logits from the conv2 kernel run on the plain
    version's conv1 map and strip scales (the same), so that conv2 is held
    on its own.  Then the chain on the strip kernel's own strips
    (``own_*``): the strips against make_strips (:func:`strips_apart`), the
    strip scales (how many differ), conv1's map as conv2's codes (share
    that differ, largest difference), the logits (share of bf16 values that
    differ, largest difference over the largest |logit|)."""
    x, q, _ = dec_i8_inputs(name, batch, g, device)
    sh = fd.strip_height(x.shape[1])
    ref = torch.stack(fd.make_strips(x, q.k1, dtype=x.dtype))
    got = fd.i8_parts_cuda(x, q, strips=ref)
    own = fd.i8_parts_cuda(x, q)
    want = fd.i8_parts_plain(x, q)
    y2 = torch.empty_like(want["y2"])
    pred2, _ = kernels.conv2_i8_head(want["y1"], sh, q.w2q, q.sw2, q.t2, q.hw, q.hb,
                                     sa=want["sa"], y2=y2)
    dq = (got["xq"].int() - want["xq"].int()).abs()
    res = {"x_code_frac": (dq > 0).float().mean().item(), "x_code_max": dq.max().item(),
           "sx_diff": int((got["sx"] != want["sx"]).sum().item()),
           "sa_diff": int((got["sa"] != want["sa"]).sum().item()),
           "sa_rel": ((got["sa"] - want["sa"]).abs() / want["sa"]).max().item()}
    for key, a, b in (("y1", got["y1"], want["y1"]), ("pred", got["pred"], want["pred"]),
                      ("y2", y2, want["y2"]), ("pred2", pred2, want["pred"])):
        res[f"{key}_frac"], res[f"{key}_steps"] = bf16_steps(a, b)
    st = strips_apart(own["strips"], ref)
    res["own_strips_frac"], res["own_strips_steps"] = st["frac"], st["steps"]
    res["own_sa_diff"] = int((own["sa"] != want["sa"]).sum().item())
    rows = torch.arange(want["y1"].shape[1], device=x.device) // (2 * sh)
    ra = (1.0 / want["sa"])[:, rows][:, :, None, None]
    dc = (torch.round(own["y1"].float() * ra) - torch.round(want["y1"].float() * ra)).abs()
    res["own_y1_code_frac"] = (dc > 0).float().mean().item()
    res["own_y1_code_max"] = dc.max().item()
    dp = (own["pred"].float() - want["pred"].float()).abs()
    res["own_pred_frac"] = (dp > 0).float().mean().item()
    res["own_pred_rel"] = (dp.max() / want["pred"].float().abs().max()).item()
    return res


def dec_i8_parts_ok(res: Dict[str, float]) -> bool:
    """Each piece exact, or one code / one bf16 step apart on at most
    I8_PART_FRAC of its elements; a scale differing at all is a fault.  On
    the strip kernel's own strips: the strips by :func:`strips_ok`, the
    strip scales exact, conv1's map one code apart on at most I8_PART_FRAC
    of its elements, the logits differing on at most I8_PART_FRAC of them
    and within REL_LIMIT."""
    return (res["x_code_frac"] <= I8_PART_FRAC and res["x_code_max"] <= 1
            and res["sx_diff"] == 0 and res["sa_diff"] == 0
            and all(res[f"{k}_frac"] <= I8_PART_FRAC and res[f"{k}_steps"] <= 1.0
                    for k in ("y1", "pred", "y2", "pred2"))
            and strips_ok({"frac": res["own_strips_frac"], "steps": res["own_strips_steps"]})
            and res["own_sa_diff"] == 0
            and res["own_y1_code_frac"] <= I8_PART_FRAC and res["own_y1_code_max"] <= 1
            and res["own_pred_frac"] <= I8_PART_FRAC and res["own_pred_rel"] <= REL_LIMIT)


def attention_case(name: str, batch: int, g, device) -> Case:
    """An attention geometry of :data:`ATTN_CASES` on seeded random qkv."""
    wrapper, l = ATTN_CASES[name]
    return _attention_case(wrapper, l, batch, g, device, torch.bfloat16)


def _attention_case(wrapper, l, batch, g, device, dtype) -> Case:
    per_image, heads, d = ATTN[l]
    qkv = torch.randn((batch * per_image, l, 3 * heads * d), generator=g).to(device, dtype)
    scale = d ** -0.5
    if wrapper == "fused_attention_lanes":
        return Case(wrapper, lambda: pa.fused_attention_lanes(qkv, heads, scale),
                    lambda: pa.lanes_plain(qkv, heads, scale))
    q, k, v = pa.split_qkv(qkv, heads)
    return Case(wrapper, lambda: pa.fused_attention(q, k, v),
                lambda: pa.attention_reference(q, k, v))


def window_inputs(name: str, batch: int, g, device):
    """Seeded bf16 qkv [batch * rows, 3 * H * d (+ a shortcut block where
    pooled, as the front's y)] of :data:`WINDOW` geometry ``name``, and the
    call's arguments (heads, d, Lk, scale)."""
    heads, d, lk, pooled, n = WINDOW[name]
    cols = 3 * heads * d + (2 * heads * d if pooled else 0)
    qkv = torch.randn((batch * n, cols), generator=g).to(device, torch.bfloat16)
    return qkv, (heads, d, lk, d ** -0.5)


def window_plain(name: str, qkv: torch.Tensor, heads: int, d: int, lk: int, scale: float):
    """The plain version of :data:`WINDOW` geometry ``name``: (output, the
    log-sum-exp of each query row's scaled scores in log2 units [rows, H])."""
    rows, f = qkv.shape[0], 3 * heads * d
    t = qkv[:, :f].reshape(rows // lk, lk, 3, heads, d)
    q = t[:, :, 0]
    if WINDOW[name][3]:   # the front's plain attention, its shortcut columns beside
        o, _ = fbt._qpool_attend(qkv[None, :, :f], qkv[None, :, f:], heads, lk, scale)
        q = q.reshape(rows // lk, lk // 4, 4, heads, d).amax(2)
    else:
        o = fbt._window_attention_plain(qkv[None, :, :f], heads, lk, scale)
    s = torch.einsum("wqhd,wkhd->wqhk", q.float(), t[:, :, 1].float()) * scale
    lse = torch.logsumexp(s, -1) * 1.4426950408889634
    return o[0], lse.reshape(-1, heads)


def window_call(name: str, qkv: torch.Tensor, heads: int, d: int, lk: int, scale: float,
                with_lse: bool = True):
    """The kernel launcher of :data:`WINDOW` geometry ``name``."""
    fn = kernels.qpool_attention if WINDOW[name][3] else kernels.window_attention
    return fn(qkv, heads, d, lk, scale, with_lse=with_lse)


def compare_window(name: str, batch: int, g, device) -> Dict[str, float]:
    """The window attention against its plain version at geometry ``name``:
    max abs error and max|k - p| / max|p| of the output, max abs error of
    the log-sum-exp (``lse``), and whether the call without the log-sum-exp
    gives the same output bit for bit (``same``)."""
    qkv, args = window_inputs(name, batch, g, device)
    o, lse = window_call(name, qkv, *args)
    o2 = window_call(name, qkv, *args, with_lse=False)
    po, plse = window_plain(name, qkv, *args)
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: window attention output is not finite")
    err, rel = _rel(o, po)
    return {"max_abs": err, "rel": rel, "lse": (lse - plse).abs().max().item(),
            "same": bool(torch.equal(o, o2))}


def window_ok(res: Dict[str, float]) -> bool:
    return res["rel"] <= REL_LIMIT and res["lse"] <= LSE_ABS_LIMIT and res["same"]


# The attention backward alone (kernels.attention_bwd,
# csrc/attention_window_bwd.cu): every WINDOW geometry whose head dim it
# takes (up to 128), the 384^2 / 352^2 grids' (stage 1 and 2 at 384^2, stage
# 1 at 352^2, the first front at 384^2), and shapes off the main path that
# reach its other cases: windows across 64-key tiles (L 48, 192; the pooled
# L 80), L 32 and 128, the pooled L 1024, head dim 16; name: (heads, head_dim, key window Lk, pooled,
# key rows per image).  Pooled: query windows of Lk / 4 rows.
ATTN_BWD = {**{n: g for n, g in WINDOW.items() if g[1] <= 128},
            "stage1_384": (2, 72, 64, False, 9216), "stage2_384": (4, 72, 16, False, 2304),
            "stage1_352": (2, 72, 64, False, 7744), "t12_384": (4, 72, 64, True, 9216),
            "l48": (2, 72, 48, False, 240), "l128": (2, 72, 128, False, 512),
            "l192": (2, 72, 192, False, 576), "p1024": (2, 72, 1024, True, 2048),
            "l32": (2, 64, 32, False, 1024), "p80": (2, 72, 80, True, 320),
            "d16": (2, 16, 64, False, 1024)}


class AttnBwdCase(NamedTuple):
    y: torch.Tensor        # the qkv (pooled: the front's y, shortcut columns beside)
    q: Optional[torch.Tensor]   # pooled: kernels.pool4_rows of y's q columns
    o: torch.Tensor
    lse: torch.Tensor
    dout: torch.Tensor
    heads: int
    d: int
    lq: int
    lk: int
    scale: float


def attn_bwd_case(name: str, batch: int, g, device) -> AttnBwdCase:
    """Seeded bf16 inputs of :data:`ATTN_BWD` geometry ``name``: the forward
    through the window attention kernel (its output and log-sum-exp, as the
    block and front backwards take them) and a random output gradient."""
    heads, d, lk, pooled, n = ATTN_BWD[name]
    hd, scale = heads * d, d ** -0.5
    y = torch.randn((batch * n, 3 * hd + (2 * hd if pooled else 0)),
                    generator=g).to(device, torch.bfloat16)
    fn = kernels.qpool_attention if pooled else kernels.window_attention
    o, lse = fn(y, heads, d, lk, scale, with_lse=True)
    q = kernels.pool4_rows(y, 0, hd) if pooled else None
    dout = torch.randn(o.shape, generator=g).to(device, torch.bfloat16)
    return AttnBwdCase(y, q, o, lse, dout, heads, d, lk // 4 if pooled else lk, lk, scale)


def attn_bwd_launch(case: AttnBwdCase, fn: Optional[Callable] = None):
    """(run, outputs) of ``fn`` (an attention backward launcher; default
    kernels.attention_bwd) on ``case`` as the block and front backwards call
    it: q / k / v in y's columns (the front: the pooled q), dk / dv into the
    k / v columns of dy, allocated once and zeroed.  ``run()`` launches;
    ``outputs()`` gives (dq, dk, dv, dy)."""
    fn = fn or kernels.attention_bwd
    y, hd, Cols = case.y, case.heads * case.d, kernels.Cols
    dy = torch.zeros_like(y)
    dq = dy if case.q is None else torch.zeros_like(case.q)
    args = (Cols(y if case.q is None else case.q), Cols(y, hd), Cols(y, 2 * hd), Cols(case.o),
            Cols(case.dout), case.lse, Cols(dq), Cols(dy, hd), Cols(dy, 2 * hd), case.heads,
            case.d, case.lq, case.lk, case.scale)
    return (lambda: fn(*args)), (lambda: (dq[:, :hd], dy[:, hd:2 * hd], dy[:, 2 * hd:3 * hd], dy))


def attn_bwd_plain(case: AttnBwdCase):
    """bf16 autograd of the plain attention (ops/attention.attention_reference)
    on the same q, k, v and output gradient: (dq, dk, dv) as [rows, H d]."""
    from spegnet_tpu_torch.ops.attention import attention_reference

    rows, hd = case.y.shape[0], case.heads * case.d
    t = case.y[:, :3 * hd].reshape(rows // case.lk, case.lk, 3, case.heads, case.d)
    q = (t[:, :, 0] if case.q is None
         else case.q.reshape(rows // case.lk, case.lq, case.heads, case.d))
    leaves = [x.detach().requires_grad_() for x in (q, t[:, :, 1], t[:, :, 2])]
    o = attention_reference(*leaves, case.scale)
    grads = torch.autograd.grad(o, leaves, case.dout.reshape(o.shape))
    return tuple(x.reshape(-1, hd) for x in grads)


def compare_attn_bwd(name: str, batch: int, g, device) -> Dict[str, object]:
    """The attention backward against bf16 autograd of the plain attention
    at geometry ``name``: max|k - p| / max|p| of dq, dk and dv (``rel``)
    and their max abs errors (``max_abs``), whether a second call gives the
    same bits (``same``), and whether the columns of dy that are not k / v
    stayed zero (``untouched``: the front's q and shortcut columns)."""
    case = attn_bwd_case(name, batch, g, device)
    run, outputs = attn_bwd_launch(case)
    run()
    *got, dy = (t.clone() for t in outputs())
    run()
    *again, dy2 = outputs()
    want = attn_bwd_plain(case)
    hd = case.heads * case.d
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError(f"{name}: attention backward is not finite")
    errs = {nm: _rel(a, b) for nm, a, b in zip(("dq", "dk", "dv"), got, want)}
    rest = dy[:, 3 * hd:] if case.q is None else torch.cat([dy[:, :hd], dy[:, 3 * hd:]], 1)
    return {"rel": {k: r for k, (_, r) in errs.items()},
            "max_abs": {k: e for k, (e, _) in errs.items()},
            "same": all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(dy, dy2),
            "untouched": bool((rest == 0).all())}


def attn_bwd_ok(res: Dict[str, object]) -> bool:
    return (max(res["rel"].values()) <= BWD_REL_LIMIT and res["same"]
            and res["untouched"])


def attn_bwd_work(name: str, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention backward of :data:`ATTN_BWD`
    geometry ``name`` at ``batch``: five products per (query row, head, key
    of its window), 2 D FLOPs each (S, dP, dV, dK, dQ), and q, k, v, o, dO
    and lse read once, dq, dk and dv written once."""
    heads, d, lk, pooled, n = ATTN_BWD[name]
    k_rows = batch * n
    q_rows = k_rows // 4 if pooled else k_rows
    flops = 10.0 * d * q_rows * heads * lk
    nbytes = 2.0 * heads * d * (4 * q_rows + 4 * k_rows) + 4.0 * q_rows * heads
    return flops, nbytes


def i8_case(name: str, batch: int, g, device) -> Case:
    """An int8 geometry: the bf16 geometry's random weights, packed to W8A8,
    through the int8 wrapper and its plain int8 version."""
    geo, wrapper = I8[name]
    if geo in QPOOL:
        cin, cout, heads, l, n = QPOOL[geo]
        wts = fbt_i8.pack_qpool_i8(qpool_weights(cin, cout, g, device))
        x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
        scale = (cout // heads) ** -0.5
        return Case(wrapper, lambda: fbt_i8.qpool_front_i8(x, wts, heads, l, scale),
                    lambda: fbt_i8.qpool_front_i8_plain(x, wts, heads, l, scale))
    _, c, heads, l, n = BLOCKS[geo]
    wts = fbt_i8.pack_i8(block_weights(c, heads, g, device))
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block_i8":
        xw = x.reshape(batch * n // l, l, c)
        return Case(wrapper, lambda: fb_i8.fused_block_i8(xw, wts, heads, scale),
                    lambda: fb_i8.block_i8_plain(xw, wts, heads, scale))
    return Case(wrapper, lambda: fbt_i8.fused_block_t_i8(x, wts, heads, l, scale),
                lambda: fbt_i8.block_t_i8_plain(x, wts, heads, l, scale))


def compare_i8(case: Case) -> Dict[str, float]:
    """Kernel vs plain int8 version: max abs error, its ratio to max |plain|,
    the share of elements beyond I8_ATOL (``frac_strict``) and beyond I8_ATOL
    plus one bf16 rounding of the output (``frac``)."""
    got, want = case.kernel(), case.plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    diffs, refs = [], []
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs plain {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        d = (a.float() - b.float()).abs().flatten()
        diffs.append(d)
        refs.append(b.float().abs().flatten())
    d, r = torch.cat(diffs), torch.cat(refs)
    err = d.max().item()
    return {"max_abs": err, "rel": err / max(r.max().item(), 1e-12),
            "frac_strict": (d > I8_ATOL).float().mean().item(),
            "frac": (d > I8_ATOL + r * 2.0 ** -8).float().mean().item()}


def i8_ok(res: Dict[str, float]) -> bool:
    return res["max_abs"] <= I8_MAX and res["rel"] <= REL_LIMIT


def _i8_gemms(name: str):
    """(N, K, gelu, residual) of each int8 GEMM of geometry ``name``."""
    if name in F32_I8:
        c = F32_BLOCKS[F32_I8[name]][0]
    else:
        geo = I8[name][0]
        if geo in QPOOL:
            cin, cout = QPOOL[geo][:2]
            return [(4 * cout, cin, False, False)]
        c = BLOCKS[geo][1]
    return [(3 * c, c, False, False), (c, c, False, True), (4 * c, c, True, False),
            (c, 4 * c, False, True)]


def i8_parts(name: str, batch: int, g, device) -> Dict[str, float]:
    """The int8 kernels of geometry ``name`` (of :data:`I8`, bf16, or
    :data:`F32_I8`, f32) alone, on its shapes, against plain PyTorch on the
    same inputs: LayerNorm + quant (share of codes that differ, largest code
    difference, largest scale difference), the row quant of a [rows, 4C]
    matrix (codes and scales that differ), and each int8 GEMM with its
    epilogue on random codes and scales.  bf16: the share of outputs that
    differ and the largest difference in bf16 steps of the plain output
    among differences above 1e-5 of the largest output; f32 (erf GELU): the
    same share and the GELU epilogues' largest difference over the largest
    output (``gelu_rel``)."""
    f32 = name in F32_I8
    dt = torch.float32 if f32 else torch.bfloat16
    if f32:
        c, n = F32_BLOCKS[F32_I8[name]][0], F32_BLOCKS[F32_I8[name]][3]
    else:
        geo = I8[name][0]
        c, n = (QPOOL[geo][0], QPOOL[geo][4]) if geo in QPOOL else (BLOCKS[geo][1],
                                                                     BLOCKS[geo][4])
    m = batch * n
    x = torch.randn((m, c), generator=g).to(device, dt)
    lnw, lnb = _v((c,), g, device, 0.1, torch.float32, 1.0), _v((c,), g, device, 0.1,
                                                                  torch.float32)
    q, s = kernels.layernorm_q8(x, lnw, lnb, 1e-6)
    qp, sp = fbt_i8.quant_tokens(fbt.layer_norm(x, lnw, lnb, 1e-6))
    dq = (q.int() - qp.int()).abs()
    out = {"ln_code_frac": (dq > 0).float().mean().item(), "ln_code_max": dq.max().item(),
           "ln_scale_rel": ((s - sp[:, 0]).abs() / sp[:, 0]).max().item()}
    z = (torch.randn((m, 4 * c), generator=g) * 0.5).to(device, dt)
    qz, sz = kernels.quant_rows(z)
    qzp, szp = fbt_i8.quant_tokens(z)
    out["rowq_diff"] = int((qz != qzp).sum().item() + (sz != szp[:, 0]).sum().item())
    worst_frac, worst_steps, gelu_rel = 0.0, 0.0, 0.0
    exact = True
    for nn_, k, gelu, res in _i8_gemms(name):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
        w = torch.randint(-127, 128, (nn_, k), generator=g, dtype=torch.int8).to(device)
        sa = (torch.rand(m, generator=g) * 0.02).to(device)
        sw = (torch.rand(nn_, generator=g) * 2e-3).to(device)
        bias = _v((nn_,), g, device, 0.1, torch.float32)
        r = torch.randn((m, nn_), generator=g).to(device, dt) if res else None
        for sw_first in (True, False):
            got = kernels.gemm_i8(a, sa, w, sw, bias, residual=r, gelu=gelu,
                                  sw_first=sw_first, out_dtype=dt,
                                  approx_gelu=not f32).float()
            want = fbt_i8.qdot(a, sa[:, None], w, sw, bias, sw_first)
            if gelu:
                want = F.gelu(want, approximate="none" if f32 else "tanh")
            want = want.to(dt)
            if r is not None:
                want = r + want
            want = want.float()
            differ = got != want
            frac = differ.float().mean().item()
            diff = (got - want).abs()
            if f32:
                if gelu:
                    gelu_rel = max(gelu_rel, (diff.max() / want.abs().max()).item())
                else:
                    worst_frac = max(worst_frac, frac)
                exact = exact and (gelu or not differ.any().item())
                continue
            _, e = torch.frexp(want)
            ulp = torch.ldexp(torch.ones_like(want), e - 8)  # one bf16 step at |want|
            # GELU of a pre-activation below ~-5 is ~1e-6 with few correct
            # bits in either tanh (1 + tanh cancels): steps there are not
            # counted when the difference is below 1e-5 of the largest output.
            counted = diff > 1e-5 * want.abs().max()
            steps = (diff / ulp)[counted].max().item() if counted.any() else 0.0
            worst_frac, worst_steps = max(worst_frac, frac), max(worst_steps, steps)
            exact = exact and (gelu or not differ.any().item())
    out.update(gemm_frac=worst_frac, gemm_steps=worst_steps, gemm_exact_no_gelu=exact)
    if f32:
        out["gelu_rel"] = gelu_rel
    return out


def i8_parts_ok(res: Dict[str, float]) -> bool:
    return (res["ln_code_frac"] <= I8_PART_FRAC and res["ln_code_max"] <= 1
            and res["rowq_diff"] == 0 and res["gemm_exact_no_gelu"]
            and res["gemm_frac"] <= I8_PART_FRAC and res["gemm_steps"] <= 1.0
            and res.get("gelu_rel", 0.0) <= I8_F32_GELU_REL)


def _tie_rows(x: torch.Tensor) -> torch.Tensor:
    """Copy rows inside the aligned 4-row pool groups: groups r % 3 == 0
    take row 0 four times (4-way ties of every pooled value), r % 3 == 1
    repeat row 0 in row 1 (2-way ties where row 0 holds the max)."""
    b, n, c = x.shape
    grp = x.reshape(b, n // 4, 4, c).clone()
    r = torch.arange(n // 4, device=x.device)
    grp[:, r % 3 == 0] = grp[:, r % 3 == 0, :1].expand(-1, -1, 4, -1)
    grp[:, r % 3 == 1, 1] = grp[:, r % 3 == 1, 0]
    return grp.reshape(b, n, c)


def qpool_weights(cin: int, cout: int, g, device) -> fbt.QPoolWeights:
    f32 = torch.float32
    return fbt.QPoolWeights(
        _v((cin,), g, device, 0.1, f32, 1.0), _v((cin,), g, device, 0.1, f32),
        _w((3 * cout, cin), cin, g, device), _v((3 * cout,), g, device),
        _w((cout, cin), cin, g, device), _v((cout,), g, device))


class GradCase(NamedTuple):
    wrapper: str                       # launch counter of the backward
    names: Tuple[str, ...]             # "x" and the weight fields
    kernel: Callable[[], Tuple]        # gradients through the kernel path
    plain: Callable[[], Tuple]         # gradients through plain autograd
    kernel_bwd: Callable[[], object]   # the kernel backward alone
    plain_bwd: Callable[[], object]    # the plain autograd backward alone


def _grad_case(wrapper, names, inputs, cot, kfn, pfn, kbwd) -> GradCase:
    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(out, leaves, cot)

    state = {}

    def plain_bwd():
        if "out" not in state:
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = pfn(*leaves)
            state["out"] = (out if isinstance(out, tuple) else (out,), leaves)
        out, leaves = state["out"]
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)

    return GradCase(wrapper, names, lambda: grads(kfn), lambda: grads(pfn), kbwd, plain_bwd)


# Backward geometries: every block and transition, plus t23 with its pool
# groups forced to tie (:func:`_tie_rows`).
GRAD_CASES = tuple(BLOCKS) + tuple(QPOOL) + ("t23_ties",)


def grad_case(name: str, batch: int, g, device) -> GradCase:
    """Backward case of a geometry of :data:`GRAD_CASES`."""
    ties = name.endswith("_ties")
    name = name[: -len("_ties")] if ties else name
    if name in QPOOL:
        cin, cout, heads, l, n = QPOOL[name]
        wts = qpool_weights(cin, cout, g, device)
        x = torch.randn((batch, n, cin), generator=g).to(device, torch.bfloat16)
        if ties:
            x = _tie_rows(x)
        d = cout // heads
        scale = d ** -0.5
        cot = (_v((batch, n // 4, cout), g, device, 1.0),
               _v((batch, n // 4, cout), g, device, 1.0))
        return _grad_case(
            "qpool_front_bwd", ("x",) + fbt.QPoolWeights._fields, (x, *wts), cot,
            lambda x, *w: fbt.qpool_front(x, fbt.QPoolWeights(*w), heads, l, scale),
            lambda x, *w: fbt.qpool_front_plain(x, fbt.QPoolWeights(*w), heads, l, scale),
            lambda: fbt.qpool_front_cuda_bwd(x, wts, cot[0], cot[1], heads, l, scale, 1e-6))
    wrapper, c, heads, l, n = BLOCKS[name]
    wts = block_weights(c, heads, g, device)
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    cot = (_v((batch, n, c), g, device, 1.0),)
    scale = (c // heads) ** -0.5
    if wrapper == "fused_block":
        win = (batch * n // l, l, c)

        def kfn(x, *w):
            return fb.fused_block(x.reshape(win), fbt.BlockWeights(*w), heads,
                                  scale).reshape(x.shape)

        def pfn(x, *w):
            return fb.block_reference(x.reshape(win), fbt.BlockWeights(*w), heads,
                                      scale).reshape(x.shape)
    else:
        def kfn(x, *w):
            with fbt.residuals_mode("0"):    # the recompute backward (#5)
                return fbt.fused_block_t(x, fbt.BlockWeights(*w), heads, l, scale)

        def pfn(x, *w):
            return fbt.block_plain(x, fbt.BlockWeights(*w), heads, l, scale)
    return _grad_case(wrapper + "_bwd", ("x",) + fbt.BlockWeights._fields, (x, *wts), cot,
                      kfn, pfn,
                      lambda: fbt.block_cuda_bwd(x, wts, cot[0], heads, l, scale, 1e-6))


class ResCase(NamedTuple):
    x: torch.Tensor
    wts: fbt.BlockWeights
    dy: torch.Tensor
    heads: int
    l: int
    scale: float


def res_case(name: str, batch: int, g, device) -> ResCase:
    """Seeded inputs, weights and output gradient of T-block geometry
    ``name`` for the saved-residual pair."""
    _, c, heads, l, n = BLOCKS[name]
    wts = block_weights(c, heads, g, device)
    x = torch.randn((batch, n, c), generator=g).to(device, torch.bfloat16)
    return ResCase(x, wts, _v((batch, n, c), g, device, 1.0), heads, l, (c // heads) ** -0.5)


def _rel(got, want) -> Tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-12)


def compare_res(case: ResCase) -> Dict[str, float]:
    """The saved-residual pair against the recompute pair and the plain
    versions on one case:
    * through the wrapper: ``fused_block_t`` under autograd with
      SAVE_RESIDUALS "1" against "0" -- elements of y and of dx and the
      twelve weight gradients that differ (``wrap_differ``);
    * the chains: :func:`fbt.block_cuda_res`'s y against
      :func:`fbt.block_cuda`'s (``fwd_differ``) and
      :func:`fbt.block_cuda_bwd_res`'s f32 gradients against
      :func:`fbt.block_cuda_bwd`'s (``bwd_differ``), elements that differ;
    * against the plain versions: the largest max|k - p| / max|p| of y and
      the residuals (``fwd_rel``) and of dx and each gradient (``bwd_rel``),
      the plain backward fed the plain forward's residuals; their max abs
      errors (``fwd_abs``, ``bwd_abs``)."""
    x, wts, dy, heads, l, scale = case
    eps = 1e-6
    wrap = {}
    for mode in ("0", "1"):
        with fbt.residuals_mode(mode):
            leaves = [t.detach().requires_grad_() for t in (x, *wts)]
            y = fbt.fused_block_t(leaves[0], fbt.BlockWeights(*leaves[1:]), heads, l, scale)
            wrap[mode] = (y.detach(), *torch.autograd.grad(y, leaves, dy))
    y, res = fbt.block_cuda_res(x, wts, heads, l, scale, eps)
    dx, dws = fbt.block_cuda_bwd_res(x, wts, dy, res, heads, l, scale, eps)
    dx0, dws0 = fbt.block_cuda_bwd(x, wts, dy, heads, l, scale, eps)
    yp, resp = fbt.block_plain_res(x, wts, heads, l, scale, eps)
    dxp, dwsp = fbt.block_plain_bwd_res(x, wts, dy, resp, heads, l, scale, eps)
    fwd = [_rel(a, b) for a, b in zip((y, *res[:5]), (yp, *resp[:5]))]
    bwd = [_rel(a, b) for a, b in zip((dx, *dws), (dxp, *dwsp))]
    if not all(torch.isfinite(t).all() for t in (y, dx, *dws)):
        raise AssertionError("the saved-residual pair gave a non-finite value")
    return {
        "wrap_differ": sum(int((a != b).sum()) for a, b in zip(wrap["1"], wrap["0"])),
        "fwd_differ": int((y != fbt.block_cuda(x, wts, heads, l, scale, eps)).sum()),
        "bwd_differ": sum(int((a != b).sum()) for a, b in zip((dx, *dws), (dx0, *dws0))),
        "fwd_rel": max(r for _, r in fwd), "fwd_abs": max(e for e, _ in fwd),
        "bwd_rel": max(r for _, r in bwd), "bwd_abs": max(e for e, _ in bwd)}


def res_ok(res: Dict[str, float]) -> bool:
    return (res["wrap_differ"] == res["fwd_differ"] == res["bwd_differ"] == 0
            and res["fwd_rel"] <= REL_LIMIT and res["bwd_rel"] <= BWD_REL_LIMIT)


def res_calls(case: ResCase) -> Dict[str, Callable[[], object]]:
    """The pair's chains and their plain versions alone, for timing:
    "fwd", "fwd_plain", "bwd", "bwd_plain" (each backward on its own
    forward's residuals)."""
    x, wts, dy, heads, l, scale = case
    _, res = fbt.block_cuda_res(x, wts, heads, l, scale, 1e-6)
    _, resp = fbt.block_plain_res(x, wts, heads, l, scale)
    return {"fwd": lambda: fbt.block_cuda_res(x, wts, heads, l, scale, 1e-6),
            "fwd_plain": lambda: fbt.block_plain_res(x, wts, heads, l, scale),
            "bwd": lambda: fbt.block_cuda_bwd_res(x, wts, dy, res, heads, l, scale, 1e-6),
            "bwd_plain": lambda: fbt.block_plain_bwd_res(x, wts, dy, resp, heads, l, scale)}


def compare_grads(case: GradCase) -> Dict[str, Tuple[float, float]]:
    """name -> (max abs error, max abs error / max |plain|) of each gradient."""
    got, want = case.kernel(), case.plain()
    out = {}
    for nm, a, b in zip(case.names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{nm}: {a.dtype} {tuple(a.shape)} vs plain "
                                 f"{b.dtype} {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{nm}: kernel gradient is not finite")
        err = (a.float() - b.float()).abs().max().item()
        out[nm] = (err, err / max(b.float().abs().max().item(), 1e-12))
    return out


def work(name: str, batch: int, backward: bool = False,
         res: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) one call of geometry ``name`` must do at ``batch``:
    its matrix products (2 per multiply-add) and each input read and each
    output written once.  A backward reads x, the output gradient and the
    weights and writes dx and the weight gradients.  The Q-pool backward
    recomputes its forward and runs two products per forward product: 3x
    the forward FLOPs.  The block backward recomputes every product but
    fc2 (qkv, proj, fc1 and the attention's two), then runs two products per
    linear layer and four per attention product pair (dP, dV, dQ, dK).
    With ``res`` (a T-block geometry), the saved-residual pair: the forward
    also writes the residuals (qkv, the attention output, u, z and g in
    bf16, lse in f32); the backward reads them instead of recomputing, and
    keeps of the recompute only P's rebuild (4 m l c, as the forward's two
    attention products)."""
    bf = 2
    if name in I8:
        return work(I8[name][0], batch)
    if name in F32_BLOCKS:
        c, heads, l, n = F32_BLOCKS[name]
        m = batch * n
        flops = 2.0 * m * (3 * c * c + c * c + 8 * c * c) + 4.0 * m * l * c
        return flops, 2 * m * c * 4 + 4 * (12 * c * c + 9 * c) + 16 * c
    if name in ATTN_CASES or name in F32_ATTN_CASES:
        l = {**ATTN_CASES, **F32_ATTN_CASES}[name][1]
        per_image, heads, d = ATTN[l]
        n = batch * per_image * heads
        return 4.0 * n * l * l * d, 4 * n * l * d * (4 if name in F32_ATTN_CASES else bf)
    if name in DECODER:
        s, cin, cm = DECODER[name]
        px = batch * (2 * s) ** 2
        flops = 2.0 * px * (9 * cin * cm + 9 * cm * cm + cm)
        wbytes = bf * (9 * cin * cm + 9 * cm * cm + cm)
        return flops, batch * s * s * cin * bf + wbytes + px * bf
    if name in DEC_EDGE:
        s, cin, ce, cm = DEC_EDGE[name]
        px = batch * (2 * s) ** 2
        flops = 2.0 * px * (9 * (cin + ce) * cm + 9 * cm * cm)
        wbytes = bf * 9 * (cin + ce + cm) * cm
        return flops, batch * (s * s * cin + (s // 2) ** 2 * ce) * bf + wbytes + px * cm * bf
    if name in QPOOL:
        cin, cout, heads, l, n = QPOOL[name]
        m = batch * n
        flops = 2.0 * m * cin * 4 * cout + 4.0 * (m // 4) * l * cout
        wbytes = bf * (4 * cout * cin + 4 * cout) + 8 * cin
        act_in, act_out = m * cin * bf, 2 * (m // 4) * cout * bf
    else:
        _, c, heads, l, n = BLOCKS[name]
        m = batch * n
        wbytes = bf * (12 * c * c + 9 * c) + 16 * c
        act_in = act_out = m * c * bf
        res_bytes = m * (13 * c * bf + 4 * heads)
        if backward and res:
            flops = 4.0 * m * l * c + 2 * 2.0 * m * 12 * c * c + 8.0 * m * l * c
            return flops, act_in + act_out + res_bytes + act_in + 2 * wbytes
        if res:
            flops = 2.0 * m * (3 * c * c + c * c + 8 * c * c) + 4.0 * m * l * c
            return flops, act_in + wbytes + act_out + res_bytes
        if backward:
            flops = (2.0 * m * (3 * c * c + c * c + 4 * c * c) + 4.0 * m * l * c
                     + 2 * 2.0 * m * 12 * c * c + 8.0 * m * l * c)
            return flops, act_in + act_out + act_in + 2 * wbytes
        flops = 2.0 * m * (3 * c * c + c * c + 8 * c * c) + 4.0 * m * l * c
    if backward:
        return 3 * flops, act_in + act_out + act_in + 2 * wbytes
    return flops, act_in + wbytes + act_out


def i8_work(name: str, batch: int) -> Tuple[float, float, float]:
    """(int8 operations, bf16 FLOPs (f32 for :data:`F32_I8`), bytes) of one
    call of int8 geometry ``name``: the projections in int8, attention in the
    activation dtype; bytes as :func:`work` with the weights as int8 codes
    and f32 scales and biases.
    The int8 decoder: both convs in int8 (conv1 over the 9 Cin x 4 Cm
    composed weights per cell), the head in bf16; bytes x (bf16) read once,
    the weight codes and f32 vectors, pred written once."""
    if name in F32_I8:
        c, heads, l, n = F32_BLOCKS[F32_I8[name]]
        m = batch * n
        wbytes = 12 * c * c + 8 * 9 * c + 16 * c
        return 2.0 * m * 12 * c * c, 4.0 * m * l * c, 2 * m * c * 4 + wbytes
    if name in DEC_I8:
        s, cin, cm = DEC_I8[name]
        cells, px = batch * s * s, batch * (2 * s) ** 2
        ops = 2.0 * cells * 9 * cin * 4 * cm + 2.0 * px * 9 * cm * cm
        wbytes = 9 * cin * 4 * cm + 9 * cm * cm + 4 * (4 * cm + 4 * cm)
        return ops, 2.0 * px * cm, cells * cin * 2 + wbytes + px * 2
    geo = I8[name][0]
    if geo in QPOOL:
        cin, cout, heads, l, n = QPOOL[geo]
        m = batch * n
        ops, attn = 2.0 * m * cin * 4 * cout, 4.0 * (m // 4) * l * cout
        wbytes = 4 * cout * cin + 8 * 4 * cout + 8 * cin
        return ops, attn, m * cin * 2 + wbytes + 2 * (m // 4) * cout * 2
    _, c, heads, l, n = BLOCKS[geo]
    m = batch * n
    wbytes = 12 * c * c + 8 * 9 * c + 16 * c
    return 2.0 * m * 12 * c * c, 4.0 * m * l * c, 2 * m * c * 2 + wbytes


def bound_ms(flops: float, nbytes: float, int8_ops: float = 0.0,
             f32: bool = False) -> Tuple[float, str]:
    """The roofline bound in ms and which side sets it: operations (FLOPs at
    the bf16 peak, or with ``f32`` at :data:`PEAK_F32`, plus int8 operations
    at the int8 peak) or bytes."""
    t_ops = (flops / (PEAK_F32 if f32 else PEAK_FLOPS) + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def all_cases() -> Dict[str, Callable]:
    """geometry name -> function (name, batch, generator, device) -> Case."""
    cases = {n: block_case for n in BLOCKS}
    cases.update({n: qpool_case for n in QPOOL})
    cases.update({n: decoder_case for n in DECODER})
    cases.update({n: edge_case for n in DEC_EDGE})
    cases.update({n: attention_case for n in ATTN_CASES})
    return cases


def f32_cases() -> Dict[str, Callable]:
    """f32 geometry name -> function (name, batch, generator, device) ->
    Case, the int8 one (:data:`F32_I8`) excluded (:func:`f32_i8_case`)."""
    cases = {n: f32_block_case for n in F32_BLOCKS}
    cases.update({n: f32_attention_case for n in F32_ATTN_CASES})
    return cases


def i8_cases() -> Dict[str, Callable]:
    """int8 encoder geometry name -> function (name, batch, generator,
    device) -> Case (the int8 decoder's are :data:`DEC_I8`, :func:`dec_i8_case`)."""
    return {n: i8_case for n in I8}


def compare(case: Case) -> Tuple[float, float]:
    """(max abs error, max abs error / max |plain|) of kernel vs plain."""
    got, want = case.kernel(), case.plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = ref = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs plain {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        err = max(err, (a.float() - b.float()).abs().max().item())
        ref = max(ref, b.float().abs().max().item())
    return err, err / max(ref, 1e-12)


def device_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2,
              attempts: int = 10) -> float:
    """Mean device time per call in ms: the summed time of the CUDA kernels
    that `iters` calls launch, from torch.profiler (no host time, unlike
    :func:`time_ms` on calls the host cannot keep ahead of).  A profiling
    session now and then records no device activity on the card's machine
    (2 of 96 short sessions in one run, 3 in a row once): such a session is
    run again, up to ``attempts`` in all, then the call raises."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError(f"torch.profiler recorded no device time in {attempts} sessions")


def time_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call on the current CUDA stream (events around `iters`
    back-to-back calls, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
