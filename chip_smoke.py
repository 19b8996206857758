#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spegnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without it) and prints the card's name and
   power limit as nvidia-smi reports them.
2. Builds the Hopper kernels from spegnet_tpu_torch/csrc into build/kernels/
   (one nvcc per source, all started together) and prints the build seconds
   and the ptxas registers and spills of each instantiation of the bf16 and
   f32 attention kernels, of the window attention (csrc/attention_window.cu),
   of the attention backward (csrc/attention_window_bwd.cu), of the
   weight-gradient GEMM, of the persistent forward GEMM
   (csrc/gemm_persistent.cuh, bf16 and int8, and its 3xTF32 form, the f32
   GEMM), of the hand-off GEMM (csrc/gemm_handoff.cuh: fc1 and the fronts'
   stacked products) and of the int8 LayerNorm + quant
   row pass (no attention kernel
   may spill at Hiera-L's head dim 72, bf16 or f32, nor any of the window
   attention's six instantiations there, nor the attention backward's nine
   there, and no instantiation of the persistent GEMM, the hand-off GEMM,
   the f32 GEMM or the row pass may spill); and of the decoder's kernels: the conv frame of
   csrc/decoder_conv.cuh (bf16 conv1, the border strips, bf16 conv2 + head,
   the int8 conv2 + head without and with its map), the int8 conv1, the
   frame's Cm 128 form of the edge branch (csrc/decoder_block.cu
   dec128_kernel: conv1, conv2 + head, conv2, at tile widths 128 and 96) and
   the LayerNorm backward (csrc/hiera_block_bwd.cu layernorm_bwd_kernel),
   none of which may spill.
3. Compares every kernel with its plain PyTorch version in bf16 at every
   main-path geometry of Hiera-L inference and training, batch 2: the
   forward kernels (at 512^2 stages 1-4, the global blocks, the t12/t23/t34
   transitions, decoder block 2; at 352^2 / 384^2 stage 1 on the T-block
   and on the gen-1 block, stage 2 on the gen-1 block, t12 and decoder
   block 2; fused_attention_lanes and fused_attention at L 64, 256, 484,
   576, 1600 and 2304) against kernel_check.REL_LIMIT, and the backward
   kernels (every block and transition geometry plus a t23 case with forced
   pool ties) against bf16 autograd of the plain version, dx and every
   weight gradient, against kernel_check.BWD_REL_LIMIT; and the
   weight-gradient GEMM (kernels.gemm_tn) at every weight gradient of those
   backwards (kernel_check.tn_shapes) against its plain version
   (ops/fused_block_t.weight_grad, f32 sums of the bf16 operands) within
   TN_REL_LIMIT, two calls bit-equal; and the hand-off GEMM alone
   (kernels.gemm / gemm_gelu_pre on csrc/gemm_handoff.cuh) at every product
   the plan sends it in a 512^2 forward at batch 8 (kernel_check.GEMM_HO:
   each stage's fc1 with its GELU and its GELU-pre, the fronts' stacked
   products) and on ragged shapes (M, N, K tails, N not a multiple of 192,
   an odd M-tile count) against its plain version
   (kernels.gemm_plain) within REL_LIMIT, two calls bit-equal, each call a
   launch of the hand-off kernel.
   Then each int8 kernel of the flagged int8 encoder (model.int8_encoder)
   against its plain int8 version at every int8 geometry of Hiera-L 512^2
   (stages 2-4, the global blocks, t23, t34), batch 2: the whole block by
   kernel_check.i8_ok (REL_LIMIT and at most one dequant step; the share of
   elements beyond the JAX package's 5e-4 is printed), and its int8 pieces
   (LayerNorm + quant, row quant, every GEMM with its epilogue) exactly or
   within one code / one bf16 step by kernel_check.i8_parts_ok.
   Then the T-block's saved-residual pair (training under
   SPEGNET_SAVE_RESIDUALS) at stage 1 / 2 / 3 and the global block, batch 8:
   through fused_block_t under autograd with SAVE_RESIDUALS "1" against "0",
   and chain by chain (block_cuda_res against block_cuda,
   block_cuda_bwd_res against block_cuda_bwd), y, dx and the twelve weight
   gradients bit-equal (0 elements differ); against the plain versions
   within REL_LIMIT (y and the residuals) and BWD_REL_LIMIT (dx and each
   gradient).  The T-block geometries include the global blocks of a 1024^2
   input (L 4096).
   Then decoder block 2 in the int8 mode (model.int8_decoder) at S 256,
   192, 176, 320 (512^2, 384^2, 352^2, 640^2), batch 2: its logits against
   the plain int8 version within REL_LIMIT, and its pieces -- x codes and
   scales, every strip's activation scale, conv1's activated map after the
   border paste, the logits, and conv2's activated map and logits from the
   conv2 kernel on the plain version's conv1 map and scales -- exact or
   within one code / one bf16 step by kernel_check.dec_i8_parts_ok (the
   chain given make_strips' strips, as the plain version takes them; then
   on the strip kernel's own strips: the strips by kernel_check.strips_ok,
   the strip scales exact, conv1's map one code apart, the logits within
   REL_LIMIT); the bf16 decoder kernels one by one at the same four sizes
   (conv1 against the plain conv1 map, conv2 + head on the plain map
   against the plain logits, within REL_LIMIT, two calls bit-equal) and the
   bf16 block's two calls bit-equal at 512^2 and 384^2; and the
   edge branch of the bf16 block (no model path) at PED block 1's geometry
   at 512^2 and 384^2, without and with a head, within REL_LIMIT, two calls
   bit-equal; and the LayerNorm backward alone (kernels.layernorm_bwd) at
   each C of a training step (kernel_check.LN_BWD: 144 / 288 / 576 / 1152),
   batch 2 and 8, without and with dres, against its plain version
   (ops/fused_block_t._layer_norm_bwd in f32) within BWD_REL_LIMIT, dx, dw
   and db, two calls bit-equal.
   Then f32 compute (use_amp: false), batch 2: every f32 kernel against its
   plain f32 version within kernel_check.F32_REL_LIMIT (2e-5) -- the gen-1
   block at stage 1 / 2 / 4 of 512^2, fused_attention_lanes at L 64, 256,
   484, 576, 1024, 1600, 4096, fused_attention at L 64, 256, 1024 -- and the
   int8 gen-1 block on f32 at stage 4 by kernel_check.i8_ok and its pieces
   by i8_parts_ok.  The f32 GEMM alone (kernels.gemm_f32) at every product
   of the f32 gen-1 blocks at 512^2 and 384^2 and a ragged shape
   (kernel_check.gemm_f32_shapes) within F32_REL_LIMIT of its plain f32
   version, two calls bit-equal; and the int8 LayerNorm + quant alone
   (kernels.layernorm_q8) at every kernel_check.LNQ8 geometry, bf16 and
   f32, by kernel_check.lnq8_ok (codes one apart on at most I8_PART_FRAC,
   scales within LNQ8_SCALE_REL, two calls bit-equal).
   Then the window attention alone (kernels.window_attention /
   qpool_attention, csrc/attention_window.cu), batch 2, at every geometry
   kernel_check.WINDOW lists (each T-block stage and global block, stage
   4's gen-1 block, the three fronts at 512^2, the 1024^2 global block at
   L 4096, head dims 96 / 128 / 256 in every work mode of
   kernels.window_plan): its output against the plain version within
   REL_LIMIT, its log-sum-exp (log2 units) against the plain scores' within
   kernel_check.LSE_ABS_LIMIT, and the output without the log-sum-exp bit
   for bit the same (kernel_check.window_ok).
   Then the attention backward alone (kernels.attention_bwd,
   csrc/attention_window_bwd.cu), batch 2, at every geometry
   kernel_check.ATTN_BWD lists (every WINDOW geometry up to head dim 128,
   those of the 384^2 / 352^2 grids, and shapes reaching its other cases):
   dq, dk and dv against bf16 autograd of the plain attention within
   BWD_REL_LIMIT, two calls bit-equal, the front's q and shortcut columns of
   dy untouched (kernel_check.attn_bwd_ok).
4. Runs the Predictor on 4 seeded synthetic 512^2 u8 images with seeded
   random Hiera-L weights in bf16, with every launch counter zeroed just
   before: every launch counter must equal the per-forward count of
   models/hiera.trunk_routes (42 T-blocks, 3 fronts, 3 gen-1 blocks) and
   decoder block 2, the hand-off GEMM (kernels.gemm_launches, counted apart
   from the wrappers that call it) must have launched, outputs must be
   finite and of the expected shapes, and
   the mask MAE against the plain f32 path (kernels=False, TF32 off) on the
   same weights must be <= 1e-3.
   4b. The same with int8_encoder: every launch counter must equal the
   per-forward count of models/hiera.trunk_routes (JAX's gates: 40 int8
   T-blocks, 2 int8 fronts, 3 int8 gen-1 blocks, 2 bf16 blocks, 1 bf16
   front, 1 decoder block), and the int8 mask MAE against the f32 plain
   path must be <= MASK_MAE_I8_LIMIT (also printed against the bf16 kernel
   path).
   Then with int8_decoder alone and with both flags (the speed mode): the
   counters equal the routes with fused_decoder_block_i8 1 per forward and
   fused_decoder_block 0, the mask MAE against the f32 plain path <=
   MASK_MAE_I8DEC_LIMIT.
   4c. The same (bf16) at 384^2, 352^2 and 640^2, whose patch grids are not
   2^k: the launch counters equal trunk_routes (at 384^2: 2 T-blocks, 1
   front, 5 gen-1 blocks, 38 fused_attention_lanes, 1 decoder block), the
   mask MAE against the f32 plain path <= 1e-3; and with int8_decoder
   (fused_decoder_block_i8 1 per forward, MAE <= MASK_MAE_I8DEC_LIMIT).
   Then the two routes no other phase runs: 1024^2 (batch 2; its three
   global blocks, L 4096, on fused_block_t), mask MAE <= 1e-3, and 768^2
   with int8_encoder (batch 4; the one grid that is not 2^k where int8
   blocks route), mask MAE <= MASK_MAE_I8_LIMIT; launches equal the routes.
5. Times the kernel path against the plain bf16 path (kernels=False), the
   int8 kernel path and the speed mode (both int8 flags) in ms/image at
   batch 8 (at 384^2 the kernel path, the speed mode and the plain bf16
   path; at 640^2 the kernel path and the plain bf16 path; in f32 at 512^2
   the kernel path and the plain f32 path), and each
   kernel -- forward and backward, the int8 ones and the f32 ones --
   against its plain version at batch 8
   with CUDA events, beside its roofline bound (kernel_check.work /
   i8_work / bound_ms); then each sub-kernel of the stage-1 and global
   geometries against the one PyTorch call that computes the same function
   (F.linear, scaled_dot_product_attention and its backward, F.layer_norm
   and its backward, a transposed matmul), the int8 GEMM of stage 3's fc1
   against torch._int_mm, each attention geometry (bf16 and f32) against
   F.scaled_dot_product_attention on the same q / k / v -- by CUDA events
   and by device time (torch.profiler, kernel_check.device_ms), per call and
   per forward, since the short-L calls are host-bound --, and the f32
   chain's GEMMs, attention and LayerNorm at stage 1 and 4 (and its window
   attention at stage 2, L 16) against F.linear, SDPA and F.layer_norm in
   f32, as yardsticks the port never calls.  The saved-residual pair's
   chains against their plain versions at its four geometries.  The
   weight-gradient GEMM at every weight gradient of a training step
   (utils/gemm_tn_bench.py: device time against torch.mm, TFLOP/s, GB/s,
   the roofline bound, the per-step totals), and the forward GEMMs at every
   forward product of a 512^2 forward (utils/gemm_bench.py: device time
   against torch.mm / torch._int_mm, TFLOP/s or TOPS, GB/s, the bound, the
   per-forward totals of #1's, #10's, the bf16 and the int8-encoder
   forward's GEMMs; and the hand-off GEMM at each of its products beside
   torch.mm, its plain version and the bound,
   per product and per forward, utils/gemm_bench.run_handoff, which give
   its row of the kernels line), the decoder's kernels piece by piece at 512^2 and
   384^2 against cuDNN's bf16 convolutions and their bounds
   (utils/decoder_bench.py; cuDNN's time is the decoder rows' library
   column), and the window attention at each geometry of a 512^2
   forward and the 1024^2 global block
   (utils/window_attention_bench.py: device ms without and with the
   log-sum-exp, events ms, the host µs a call takes to enqueue, SDPA's
   device ms on the same windows, the bound, the per-forward totals), and
   the attention backward at each geometry of a 512^2 and a 384^2 training
   step and the 1024^2 global block (utils/attention_bwd_bench.py: device
   ms and each of its kernels', host µs per call, SDPA's backward on the
   same windows, the bound, the per-step totals), the f32 GEMM at every
   f32 gen-1 product against F.linear in f32 and its bound at
   kernel_check.PEAK_F32 (utils/gemm_bench.py --f32), and the int8 LayerNorm + quant at each
   kernel_check.LNQ8 geometry against its plain version and its bytes
   bound (utils/gemm_bench.py --lnq8).
6. Training, Hiera-L 512^2, bf16 compute, f32 master weights, synthetic
   TrainBatches (u8 images; {0,1} ellipse masks at original sizes 384-640 on
   a 640 canvas; edges their morphological boundary):
   (a) batch 2, same weights and batch: the gradient through the kernel
       path, the plain bf16 path and the plain f32 path (TF32 off); the
       cosine of each bf16 gradient to the f32 one, overall and for the
       encoder group, and the kernel path no worse than the plain bf16 path
       by more than 0.01;
   (b) batch 8: three Trainer steps on the kernel path with every launch
       counter zeroed just before (losses finite, every counter equal to
       three times the training routes under the default
       SPEGNET_SAVE_RESIDUALS, parameters and BN running statistics
       changed), then four more; ms/step of the six steps after the first
       (CUDA events, each and their median) and peak memory, for the kernel
       and the plain bf16 path.
   (c) the same at 384^2: gradient cosines at batch 2, then three Trainer
       steps at batch 8 on the kernel path and on the plain bf16 path,
       every forward and backward counter equal to three times the routes'.
   (d) the saved-residual pair: at batch 2 (512^2) the whole model's
       gradient under SAVE_RESIDUALS "1" (42 blocks on the pair; "auto" is
       the same at batch 2) and a second one under "0": the "1" gradient's
       cosine to the f32 path no lower than the "0" path's less
       COSINE_MARGIN, and its cosine to the "0" gradient printed beside the
       two "0" runs'.  Those runs differ (the decoder's bilinear upsample
       backward adds in bf16 with atomics, in no fixed order), so the pair
       is held exactly on the trunk: its gradients for one fixed cotangent
       on its four stage outputs, cuDNN deterministic, under "0" twice and
       "1" -- every parameter whose two "0" gradients are equal has the same
       gradient under "1", bit for bit; any other (the position embedding,
       behind a bicubic upsample backward with atomics) a cosine to the "0"
       gradient no lower than the two "0" runs' less RES_COS_SLACK.  At
       batch 8, 3 Trainer steps under
       "0", "1", "auto" on one Trainer: every counter equal to three times
       the training routes (models/hiera.trunk_routes with train_batch: 0 /
       42 / 40 blocks on the pair) and peak memory; then RES_ROUNDS rounds
       of one step per mode in rotating order: ms/step of each, and each
       mode's step against "0"'s of the same round (median difference,
       rounds faster).
   (f) f32 compute at 512^2: the batch-2 gradient through the f32 kernel
       path and the plain f32 path, cosine >= COSINE_F32_LIMIT overall and
       for the encoder; 3 Trainer steps at batch 8 on each path (the kernel
       path's counters equal to three times the f32 routes, no backward
       counter moving: the f32 backwards recompute through the plain
       versions, as in JAX), ms/step and peak memory.
   (e) validation: 12 seeded 512^2 PNG samples written to a temporary
       directory (data/png.py, no Pillow needed), one epoch of Trainer.train
       with val_ratio 0.25 (9 train, 3 val) at batch 8: the val metrics in
       metrics.json finite, model_best.pth written and loadable, and the
       metrics of the validation forward's own logits (captured from the
       model) on the card equal to those on the CPU from the same quantized
       predictions within METRIC_TOL, and to the logged val metrics.
7. Evaluate: the Evaluator in memory on 8 synthetic eval samples (ellipse
   ground truths at original sizes 384-640 on a 640 canvas, their distance
   transforms from scipy) for the bf16 config, int8_encoder, and both int8
   flags: metrics finite
   and in [0, 1], the card's metrics equal to the port's CPU metrics on the
   same quantized predictions within 1e-5, forward and metrics ms/image;
   then the bf16 config at 384^2, and the f32 config at 512^2.
8. Data parallelism, remat, the config's batch, sequence parallelism, the
   model report (Hiera-L, seeded random weights, bf16):
   (a) a Trainer under DistributedDataParallel with one rank over NCCL
       (a file store in a temporary directory; the group left after)
       against the plain Trainer, 512^2 batch 8: the loss bit-equal, every
       gradient bucket unchanged by the reduction (a comm hook), and the
       plain Trainer's clip and AdamW on the DDP step's gradients giving
       its parameters and running statistics bit for bit (two backwards of
       one step differ: the bilinear upsample backward adds with atomics);
       launches = the training routes;
   (b) two ranks spawned on the one card over gloo (a file store): the DDP
       step at global batch 8 and at its first 7 samples (the pad weighted
       0), against one process on the same global batch (the tail padded
       with its weights, as the global program sees it): the loss, the
       clipped gradients' cosine, the parameter update and the running
       statistics within DDP_*_LIMIT (2.5x the worst first reading), each
       rank's launches = the routes at batch 4;
   (c) the Evaluator over the two ranks (batch 8) against one (batch 4) on
       8 synthetic samples: the per-sample metrics within METRIC_TOL;
   (d) the Predictor over the two ranks (batch 8) against one (batch 4) on
       8 PNG images: the binary masks (written by data/png.py: the card's
       machine has no OpenCV) byte for byte, the summary counts;
   (e) training.remat on against off at 384^2 batch 8: the losses equal,
       the whole model's gradient cosine to the off run no lower than a
       second off run's less REMAT_COS_SLACK, the trunk's gradients for one
       cotangent bit-equal wherever two off runs are; 3 steps per mode:
       peak memory lower with remat, ms/step, launches = the routes with
       fused_attention_lanes twice per step under remat;
   (f) the config's batch 42 at 512^2 with remat at its default (on): two
       Trainer steps, ms/step, peak memory <= PEAK_LIMIT_GB, launches = the
       routes;
   (g) sequence parallelism: two ranks spawned on the card over gloo,
       {"data": 1, "sp": 2} (model.spatial_axis "sp"), Hiera-L bf16 at
       1024^2, against one process's kernel path and against one process
       on the two ranks' routes (the S = 2 plan run whole, its gathers
       no-ops): predict batch 2 (each rank's launches = trunk_routes
       under S = 2: 39 T-blocks, 3 fronts, 3 gen-1, 3 global_ref, decoder
       0; the stage outputs before block 23, the first global block,
       bit-equal or within REL_LIMIT of the kernel path's; mask MAE <=
       MASK_MAE_LIMIT; ms/img and peak memory per rank beside one
       process's), evaluate 4 samples (mask MAE <= MASK_MAE_LIMIT against
       the kernel path, per-sample metrics within SP_EMU_METRIC_LIMIT of
       the two ranks' routes in one process, whose head runs whole;
       against the kernel path printed), one train step batch 2 (loss,
       clipped gradients' cosine, update, running statistics within
       SP_*_LIMIT of the kernel path's; against the two ranks' routes in
       one process the loss bit-equal, the rest within SP_EMU_*_LIMIT; the
       gradient's cosine to the plain f32 path no lower than one
       process's less COSINE_MARGIN; the ranks' parameters bit-equal;
       launches = the training routes under S = 2); each rank's head on
       its band of rows (models/hiera.head_bands: rows [s h / 2, (s + 1)
       h / 2) of every head map, predict and train, printed and checked),
       its peak memory beside PR 18's (the head whole) and one process's,
       the train peak below PR 18's;
   (h) the model (tensor-parallel) axis: two ranks spawned on the card over
       gloo, {"data": 1, "model": 2}, Hiera-L bf16, each holding half of
       the encoder's qkv, proj, fc1 and fc2, against one process on the same
       weights and batches: one train step at 384^2 batch 4 (the lanes
       attention on H / 2 heads, the gen-1 and T-blocks on gathered
       weights) and one at 512^2 batch 2 (every block on a kernel with
       gathered weights, the fronts' tails Megatron-style): launches = the
       training routes, loss, clipped gradients' cosine (gathered), update
       and running statistics within TP_*_LIMIT, the replicated parameters
       bit-equal across the ranks, peak memory per rank beside one
       process's and the prediction; the 512^2 step's checkpoint (gathered,
       the reference schema) loaded into one process, whose next step is
       held to the same limits against the ranks'; predict 512^2 batch 2
       (launches = the routes, mask MAE <= MASK_MAE_LIMIT) and evaluate 4
       samples (metrics within METRIC_TOL);
   (i) the CAMO edge processor (utils/camo_edges.py) on the card against
       its CPU run on 16 seeded synthetic 512^2 masks: edges and validity
       bit-equal, ms per mask;
   (j) the spatial axis and the model axis in one mesh: four ranks spawned
       on the card over gloo, {"data": 1, "sp": 2, "model": 2}
       (model.spatial_axis "sp"), Hiera-L bf16, against one process's
       kernel path and against one process on the ranks' routes (the S =
       2 plan run whole, full weights): predict 512^2 batch 2 through the
       Predictor (full weights, each rank's launches = trunk_routes under
       S = 2, decoder 0; mask MAE <= MASK_MAE_LIMIT), evaluate 4 samples
       (metrics within SPM_EMU_METRIC_LIMIT of the ranks' routes in one
       process, whose head runs whole),
       one train step 512^2 batch 2 on the token shards with the matmuls
       split (launches = the training routes under S = 2, the _bwd
       counters included; loss, clipped gradients' cosine, update and
       running statistics within SPM_*_LIMIT of the kernel path's and
       SPM_EMU_*_LIMIT of the ranks' routes'; the gradient's cosine to the
       plain f32 path no lower than one process's less COSINE_MARGIN; the
       replicated parameters bit-equal on all ranks, each shard across its
       spatial group), the step's checkpoint loaded into one process,
       whose next step is held to SPM_*_LIMIT against the ranks', and the
       trainer's eval-mode forward at 384^2 batch 2 on the sharded model
       (launches = the routes, 38 fused_attention_lanes at H / 2 heads,
       mask MAE <= MASK_MAE_LIMIT); each rank's head on the band of its
       spatial index (predict and train, printed and checked); peak
       memory per rank beside PR 20's (the head whole), 8g's, 8h's and
       one process's, seconds per step, the phase's seconds;
   then the model report (utils/model_info.py) at 512^2.
9. No module of JAX, flax, optax or the JAX package was imported by any of
   the above.

Any failed check raises.  The last lines are the kernel table (JSON; the
f32 rows, KERNELS' dtype "f32", are the f32 kernels behind the same
wrappers, their launches read from the f32 runs; the gemm_handoff row is
the GEMM inside #1, #3 and #7, its launches those of the predict runs;
the bf16 rows' launches include phase 8's runs, every rank's of 8b, 8g, 8h
and 8j), the nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
MASK_MAE_LIMIT = 1e-3   # BASELINE.md:41 drift budget
# int8 encoder mask MAE vs the f32 plain path: the JAX package calls int8
# accuracy a measured quantity; this limit is 2.5x the first value measured
# on an H100 (4.9432e-04, PERF.md), the convention of the backward limit.
MASK_MAE_I8_LIMIT = 1.24e-3
# int8 decoder (alone or with the int8 encoder) mask MAE vs the f32 plain
# path, at every size: the same convention, 2.5x the first value measured
# on an H100 (5.0707e-04, 512^2 with int8_decoder alone, PERF.md).
MASK_MAE_I8DEC_LIMIT = 1.27e-3
METRIC_TOL = 1e-5
COSINE_MARGIN = 0.01
# f32 compute (use_amp: false): the kernel path's masks against the plain f32
# path, and its gradient's cosine to the plain f32 gradient; both are f32 on
# every kernel (3xTF32 products), so they differ by summation order only.
MASK_MAE_F32_LIMIT = 1e-5
COSINE_F32_LIMIT = 0.9999
# The weight-gradient GEMM against its plain version (f32 sums of the same
# bf16 products): the tensor cores' own accumulation truncates, which over a
# split of up to 8192 rows (kernels.TN_MAX_SPLIT) biases a sum by ~1e-5 of
# it.
TN_REL_LIMIT = 1e-4
TIMED_STEPS = 6   # train steps timed after the warm-up step (512^2)
GRID_SIZES = (384, 352, 640)   # inputs whose patch grid is not 2^k


class Row(NamedTuple):
    """One row of the kernels line."""
    source: str
    replaces: str        # the TPU kernel it replaces
    counter: str         # its wrapper's launch counter
    dtype: str = "bf16"  # the runs its launches are read from: "bf16" or "f32"
    library: bool = False  # PyTorch calls compute the same function (SDPA, cuDNN's convs)


KERNELS = {
    "fused_block_t": Row("spegnet_tpu_torch/csrc/hiera_block.cu",
                         "spegnet_tpu/ops/fused_block_t.py:349", "fused_block_t"),
    "fused_block": Row("spegnet_tpu_torch/csrc/hiera_block.cu",
                       "spegnet_tpu/ops/fused_block.py:99", "fused_block"),
    "qpool_front": Row("spegnet_tpu_torch/csrc/qpool_front.cu",
                       "spegnet_tpu/ops/fused_block_t.py:634", "qpool_front"),
    "fused_decoder_block": Row("spegnet_tpu_torch/csrc/decoder_block.cu",
                               "spegnet_tpu/ops/fused_decoder.py:338", "fused_decoder_block",
                               library=True),
    "fused_block_t_bwd": Row("spegnet_tpu_torch/csrc/hiera_block_bwd.cu",
                             "spegnet_tpu/ops/fused_block_t.py:1165", "fused_block_t_bwd"),
    "fused_block_bwd": Row("spegnet_tpu_torch/csrc/hiera_block_bwd.cu",
                           "spegnet_tpu/ops/fused_block.py:274", "fused_block_bwd"),
    "qpool_front_bwd": Row("spegnet_tpu_torch/csrc/qpool_front_bwd.cu",
                           "spegnet_tpu/ops/fused_block_t.py:833", "qpool_front_bwd"),
    "fused_block_t_i8": Row("spegnet_tpu_torch/csrc/int8_gemm.cu",
                            "spegnet_tpu/ops/fused_block_t_i8.py:137", "fused_block_t_i8"),
    "qpool_front_i8": Row("spegnet_tpu_torch/csrc/int8_gemm.cu",
                          "spegnet_tpu/ops/fused_block_t_i8.py:294", "qpool_front_i8"),
    "fused_block_i8": Row("spegnet_tpu_torch/csrc/int8_gemm.cu",
                          "spegnet_tpu/ops/fused_block_i8.py:128", "fused_block_i8"),
    "fused_attention_lanes": Row("spegnet_tpu_torch/csrc/attention_lanes.cu",
                                 "spegnet_tpu/ops/pallas_attention.py:199",
                                 "fused_attention_lanes", library=True),
    "fused_attention": Row("spegnet_tpu_torch/csrc/attention_lanes.cu",
                           "spegnet_tpu/ops/pallas_attention.py:43", "fused_attention",
                           library=True),
    "fused_decoder_block_i8": Row("spegnet_tpu_torch/csrc/decoder_i8.cu",
                                  "spegnet_tpu/ops/fused_decoder.py:338",
                                  "fused_decoder_block_i8", library=True),
    "fused_decoder_block_edge": Row("spegnet_tpu_torch/csrc/decoder_block.cu",
                                    "spegnet_tpu/ops/fused_decoder.py:338",
                                    "fused_decoder_block_edge", library=True),
    "fused_block_t_res": Row("spegnet_tpu_torch/csrc/hiera_block.cu",
                             "spegnet_tpu/ops/fused_block_t.py:362", "fused_block_t_res"),
    "fused_block_t_bwd_res": Row("spegnet_tpu_torch/csrc/hiera_block_bwd.cu",
                                 "spegnet_tpu/ops/fused_block_t.py:1449",
                                 "fused_block_t_bwd_res"),
    # fc1 + GELU and the fronts' stacked product inside #1 / #2 / #3 / #7:
    # its launches from the predict runs, its times per 512^2 forward
    # (utils/gemm_bench.run_handoff)
    "gemm_handoff": Row("spegnet_tpu_torch/csrc/gemm_handoff.cuh",
                        "spegnet_tpu/ops/fused_block_t.py:339", "gemm_handoff"),
    # f32 compute: the f32 kernels behind the same wrappers
    "fused_block_f32": Row("spegnet_tpu_torch/csrc/block_f32.cu",
                           "spegnet_tpu/ops/fused_block.py:99", "fused_block", "f32"),
    "fused_attention_lanes_f32": Row("spegnet_tpu_torch/csrc/attention_f32.cu",
                                     "spegnet_tpu/ops/pallas_attention.py:199",
                                     "fused_attention_lanes", "f32", library=True),
    "fused_attention_f32": Row("spegnet_tpu_torch/csrc/attention_f32.cu",
                               "spegnet_tpu/ops/pallas_attention.py:43", "fused_attention",
                               "f32", library=True),
    "fused_block_i8_f32": Row("spegnet_tpu_torch/csrc/int8_gemm.cu",
                              "spegnet_tpu/ops/fused_block_i8.py:128", "fused_block_i8", "f32"),
}
# (counter, dtype) -> row of KERNELS
ROW = {(r.counter, r.dtype): name for name, r in KERNELS.items()}
# bf16 rows whose per-forward numbers are those of a 384^2 forward
AT_384 = ("fused_attention_lanes", "fused_attention")
RES_MODES = ("0", "1", "auto")   # SPEGNET_SAVE_RESIDUALS values
RES_ROUNDS = 10   # timed rounds of one train step per SAVE_RESIDUALS mode
# Slack of a cosine between two f32 gradients that differ only by the order
# of atomic adds (the trunk's position-embedding upsample backward).
RES_COS_SLACK = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def train_config(batch: int, size: int = 512):
    return {"model": {"encoder": {"variant": "large", "checkpoint_path": None},
                      "compute_dtype": "bfloat16", "image_processing": {"target_size": size}},
            "training": {"batch_size": batch, "num_epochs": 1, "val_ratio": 0, "num_workers": 2,
                         "gradient_clip": 1, "canvas_buckets": [512, 640, 768],
                         "optimizer": {"learning_rate": 1e-4, "weight_decay": 1e-5,
                                       "encoder_lr_ratio": 0.05}}}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils import decoder_bench
    from spegnet_tpu_torch.utils.weights import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    t0 = time.perf_counter()
    so = kernels.build(verbose=True, echo=False)
    kernels.load()
    log(f"build: {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for kern, n72 in (("attention_wgmma_kernel", 3), ("attention_tf32_kernel", 1),
                      ("attention_f32_kernel", 0), ("gemm_tn_kernel", 0)):
        usage = kernels.ptxas_usage(kern)
        log(f"ptxas {kern} (template arguments: registers, spill store / load bytes): "
            + ", ".join(f"{w}: {r}, {ss} / {sl}" for w, r, ss, sl in sorted(usage)))
        at72 = [u for u in usage if u[0][0] == 72]
        check(len(at72) == n72 and all(ss == sl == 0 for _, _, ss, sl in at72),
              f"{kern}<72, *> (Hiera-L's head dim) spills or was not built: {usage}")
    # the window attention (csrc/attention_window.cu): (DV, SHARED, MT, MASK,
    # POOL); the six at DV 72 (Hiera-L's head dim) may not spill
    usage = kernels.ptxas_usage("window_attention_kernel")
    log("ptxas window_attention_kernel (template arguments: registers, spill store / load "
        "bytes): " + ", ".join(f"{w}: {r}, {ss} / {sl}" for w, r, ss, sl in sorted(usage)))
    at72 = [u for u in usage if u[0][0] == 72]
    check(len(at72) == 6 and all(ss == sl == 0 for _, _, ss, sl in at72),
          f"window_attention_kernel<72, *> spills or was not built: {usage}")
    # the attention backward (csrc/attention_window_bwd.cu): the packed
    # kernel (DV, QT, MASK), the dQ kernel (DV, SHARED, MASK) and the dK / dV
    # kernel (DV, SHARED); none of the nine at DV 72 (Hiera-L's head dim) may
    # spill
    for kern, n72 in (("attn_bwd_packed_kernel", 4), ("attn_bwd_dq_kernel", 3),
                      ("attn_bwd_dkdv_kernel", 2)):
        usage = kernels.ptxas_usage(kern)
        log(f"ptxas {kern} (template arguments: registers, spill store / load bytes): "
            + ", ".join(f"{w}: {r}, {ss} / {sl}" for w, r, ss, sl in sorted(usage)))
        at72 = [u for u in usage if u[0][0] == 72]
        check(len(at72) == n72 and all(ss == sl == 0 for _, _, ss, sl in at72),
              f"{kern}<72, *> spills or was not built: {usage}")
    # the persistent GEMM's instantiations (csrc/gemm_persistent.cuh): bf16 (BN,
    # ACT) and int8 (BN, ACT, SW_FIRST, output type), the hand-off GEMM beside
    # it (csrc/gemm_handoff.cuh: ACT), the f32 GEMM (ACT) and the
    # LayerNorm + quant row pass (T, NV, WREG); none may spill
    # and the decoder's: the frame of csrc/decoder_conv.cuh (MODE: conv1, the
    # strips, conv2 + head, the int8 conv2 without / with y2), the int8 conv1
    # and the frame's Cm 128 form of the edge branch (MODE: conv1 over up2(x)
    # + up4(ef), conv2 + head, conv2; TC: 128, 96); and the LayerNorm
    # backward (NV: 1-5, the narrow form; 16, the wide)
    for kern, n_inst in (("gemm_bf16_kernel", 8), ("gemm_i8_kernel", 14),
                         ("gemm_handoff_kernel", 3), ("gemm_f32_kernel", 3),
                         ("layernorm_q8_kernel", 4), ("dec_conv_kernel", 5),
                         ("polyconv1_i8_kernel", 1), ("dec128_kernel", 6),
                         ("layernorm_bwd_kernel", 6)):
        usage = kernels.ptxas_usage(kern)
        log(f"ptxas {kern} (template arguments: registers, spill store / load bytes): "
            + ", ".join(f"{w}: {r}, {ss} / {sl}" for w, r, ss, sl in sorted(usage, key=str)))
        check(len(usage) == n_inst and all(ss == sl == 0 for _, _, ss, sl in usage),
              f"{kern} spills or was not built: {usage}")

    # -- 3. every kernel vs its plain version at every main-path geometry ----
    cases = kc.all_cases()
    max_err = {w: 0.0 for w in KERNELS}
    for name, make in cases.items():
        case = make(name, 2, torch.Generator().manual_seed(1), dev)
        err, rel = kc.compare(case)
        torch.cuda.synchronize()
        max_err[case.wrapper] = max(max_err[case.wrapper], err)
        log(f"check {name:8s} {case.wrapper:20s} max_abs {err:.4e} rel {rel:.4e} "
            f"(limit {kc.REL_LIMIT})")
        check(rel <= kc.REL_LIMIT, f"{name}: kernel disagrees with plain ({rel:.3e})")
    for name in kc.GRAD_CASES:
        case = kc.grad_case(name, 2, torch.Generator().manual_seed(1), dev)
        errs = kc.compare_grads(case)
        torch.cuda.synchronize()
        worst = max(errs, key=lambda k: errs[k][1])
        max_err[case.wrapper] = max(max_err[case.wrapper], max(e for e, _ in errs.values()))
        log(f"check {name:8s} {case.wrapper:20s} rel " + " ".join(
            f"{k} {r:.2e}" for k, (_, r) in errs.items()) + f" (limit {kc.BWD_REL_LIMIT})")
        check(errs[worst][1] <= kc.BWD_REL_LIMIT,
              f"{name}: backward {worst} disagrees with plain autograd ({errs[worst][1]:.3e})")
    tn_checks(kc, kernels, torch, dev)
    # the hand-off GEMM alone at every product the plan sends it (batch 8)
    # and on ragged shapes
    for name in kc.GEMM_HO:
        res = kc.compare_gemm_ho(name, 8, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        max_err["gemm_handoff"] = max(max_err["gemm_handoff"], res["max_abs"])
        log(f"check {name:16s} gemm_handoff M N K epilogue {kc.gemm_ho_shape(name, 8)}: "
            f"max_abs {res['max_abs']:.4e} rel {res['rel']:.4e} (limit {kc.REL_LIMIT}), two "
            f"calls bit-equal {res['same']}, launches {res['launched']} of 2")
        check(kc.gemm_ho_ok(res), f"{name}: the hand-off GEMM disagrees ({res})")
    for name in kc.RES:
        res = kc.compare_res(kc.res_case(name, 8, torch.Generator().manual_seed(1), dev))
        torch.cuda.synchronize()
        max_err["fused_block_t_res"] = max(max_err["fused_block_t_res"], res["fwd_abs"])
        max_err["fused_block_t_bwd_res"] = max(max_err["fused_block_t_bwd_res"], res["bwd_abs"])
        log(f"check {name:8s} saved-residual pair batch 8: elements that differ from the "
            f"recompute pair: wrapper (y, dx, 12 grads) {res['wrap_differ']}, forward chain "
            f"{res['fwd_differ']}, backward chain {res['bwd_differ']}; vs plain: forward rel "
            f"{res['fwd_rel']:.2e} (limit {kc.REL_LIMIT}), backward rel {res['bwd_rel']:.2e} "
            f"(limit {kc.BWD_REL_LIMIT})")
        check(kc.res_ok(res), f"{name}: the saved-residual pair disagrees ({res})")
        torch.cuda.empty_cache()
    for name, make in kc.i8_cases().items():
        case = make(name, 2, torch.Generator().manual_seed(1), dev)
        res = kc.compare_i8(case)
        torch.cuda.synchronize()
        max_err[case.wrapper] = max(max_err[case.wrapper], res["max_abs"])
        log(f"check {name:9s} {case.wrapper:20s} max_abs {res['max_abs']:.4e} rel "
            f"{res['rel']:.4e} (limits {kc.I8_MAX}, {kc.REL_LIMIT}); elements beyond "
            f"{kc.I8_ATOL}: {res['frac_strict']:.4%}, beyond it + 1 bf16 step: "
            f"{res['frac']:.4%}")
        check(kc.i8_ok(res), f"{name}: int8 kernel disagrees with plain int8 ({res})")
        parts = kc.i8_parts(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:9s} int8 pieces: {parts} (limits share {kc.I8_PART_FRAC}, one "
            f"code / one bf16 step; row quant and GEMM without GELU exact)")
        check(kc.i8_parts_ok(parts), f"{name}: an int8 piece disagrees with plain ({parts})")
    for name in kc.DEC_I8:
        res = kc.dec_bf16_parts(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:10s} bf16 decoder kernels: conv1 rel {res['y1_rel']:.4e}, conv2 + "
            f"head rel {res['pred_rel']:.4e} (limit {kc.REL_LIMIT}); two calls bit-equal: "
            f"{res['y1_same']}, {res['pred_same']}")
        check(kc.dec_bf16_parts_ok(res), f"{name}: a bf16 decoder kernel disagrees ({res})")
    # the edge branch with its head (without it: the cases above), two calls
    # bit-equal either way
    for name in kc.DEC_EDGE:
        for head in (False, True):
            case = kc.edge_case(name, 2, torch.Generator().manual_seed(1), dev, head=head)
            err, rel = kc.compare(case)
            a, b = case.kernel(), case.kernel()
            torch.cuda.synchronize()
            max_err[case.wrapper] = max(max_err[case.wrapper], err)
            log(f"check {name:12s} {case.wrapper} head {head}: max_abs {err:.4e} rel "
                f"{rel:.4e} (limit {kc.REL_LIMIT}), two calls bit-equal {torch.equal(a, b)}")
            check(rel <= kc.REL_LIMIT and torch.equal(a, b),
                  f"{name}: the edge branch disagrees with plain ({rel:.3e}) or repeats badly")
            del case, a, b
    # the LayerNorm backward alone at every C of a training step
    for name in kc.LN_BWD:
        for batch in (2, 8):
            for dres in (False, True):
                res = kc.compare_ln_bwd(name, batch, dres, torch.Generator().manual_seed(1), dev)
                torch.cuda.synchronize()
                log(f"check {name:8s} layernorm_bwd C {kc.LN_BWD[name][0]} batch {batch} dres "
                    f"{dres}: rel dx {res['dx']:.2e} dw {res['dw']:.2e} db {res['db']:.2e} "
                    f"(limit {kc.BWD_REL_LIMIT}), two calls bit-equal {res['same']}")
                check(kc.ln_bwd_ok(res), f"{name}: the LayerNorm backward disagrees ({res})")
    for name in kc.DECODER:
        case = kc.decoder_case(name, 2, torch.Generator().manual_seed(1), dev)
        a, b = case.kernel(), case.kernel()
        torch.cuda.synchronize()
        log(f"check {name:10s} fused_decoder_block two calls bit-equal: {torch.equal(a, b)}")
        check(torch.equal(a, b), f"{name}: two calls of the decoder differ")
        del case
    for name in kc.DEC_I8:
        case = kc.dec_i8_case(name, 2, torch.Generator().manual_seed(1), dev)
        err, rel = kc.compare(case)
        torch.cuda.synchronize()
        max_err[case.wrapper] = max(max_err[case.wrapper], err)
        log(f"check {name:10s} {case.wrapper:22s} max_abs {err:.4e} rel {rel:.4e} "
            f"(limit {kc.REL_LIMIT})")
        check(rel <= kc.REL_LIMIT, f"{name}: int8 decoder disagrees with plain int8 ({rel:.3e})")
        parts = kc.dec_i8_parts(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:10s} int8 decoder pieces: {parts} (limits share {kc.I8_PART_FRAC}, "
            f"one code / one bf16 step, scales exact; on the strip kernel's strips: strips "
            f"one step of max(|v|, peak / 256), conv1's map one code, logits within "
            f"{kc.REL_LIMIT})")
        check(kc.dec_i8_parts_ok(parts), f"{name}: an int8 decoder piece disagrees ({parts})")
    f32_checks(kc, torch, dev, max_err)
    for name in kc.WINDOW:
        res = kc.compare_window(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:11s} window attention max_abs {res['max_abs']:.4e} rel "
            f"{res['rel']:.4e} (limit {kc.REL_LIMIT}), lse max_abs {res['lse']:.3e} (limit "
            f"{kc.LSE_ABS_LIMIT}), without lse bit-equal {res['same']}")
        check(kc.window_ok(res), f"{name}: the window attention disagrees with plain ({res})")
    for name in kc.ATTN_BWD:
        res = kc.compare_attn_bwd(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:11s} attention backward rel " + " ".join(
            f"{k} {r:.2e}" for k, r in res["rel"].items()) + f" (limit {kc.BWD_REL_LIMIT}), "
            f"two calls bit-equal {res['same']}, other columns untouched {res['untouched']}")
        check(kc.attn_bwd_ok(res), f"{name}: the attention backward disagrees ({res})")

    # -- 4. the Predictor on the main path -----------------------------------
    cfg = SPEGNetConfig(variant="large", compute_dtype="bfloat16")
    model = init_weights(SPEGNet(cfg), torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
    model_config = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
                    "image_processing": {"target_size": 512}}
    predictor = Predictor(None, model_config, None, batch_size=4, device="cuda",
                          model=model)
    launches, launches_f32 = {}, {}   # per run: launch counts of the bf16 / f32 runs
    seg, edge, launches["predict"] = predict_checked(predictor, images, 512, False, torch)
    check(launches["predict"]["gemm_handoff"] > 0, "the main path ran no hand-off GEMM")
    x = torch.from_numpy(np.stack([predictor.processor.process_array(a)
                                   for a in images])).to(dev)
    seg32, edge32 = f32_masks(state, x, torch, dev)
    mae = float(np.abs(seg - seg32).mean())
    log(f"predict: mask MAE vs f32 plain {mae:.4e} (limit {MASK_MAE_LIMIT}), "
        f"max {np.abs(seg - seg32).max():.4e}; edge MAE {np.abs(edge - edge32).mean():.4e}")
    check(mae <= MASK_MAE_LIMIT, f"mask MAE {mae:.3e} > {MASK_MAE_LIMIT}")

    # -- 4b. the Predictor with the int8 encoder -------------------------------
    cfg_i8 = SPEGNetConfig(variant="large", compute_dtype="bfloat16", int8_encoder=True)
    model_i8 = SPEGNet(cfg_i8)
    model_i8.load_state_dict(state)
    pred_i8 = Predictor(None, {**model_config, "int8_encoder": True}, None, batch_size=4,
                        device="cuda", model=model_i8)
    seg_i8, edge_i8, launches["predict_int8"] = predict_checked(pred_i8, images, 512, True,
                                                                torch)
    mae_i8 = float(np.abs(seg_i8 - seg32).mean())
    log(f"predict int8: mask MAE vs f32 plain {mae_i8:.4e} (limit {MASK_MAE_I8_LIMIT}), "
        f"max {np.abs(seg_i8 - seg32).max():.4e}; vs bf16 kernel path "
        f"{np.abs(seg_i8 - seg).mean():.4e}; edge MAE vs f32 plain "
        f"{np.abs(edge_i8 - edge32).mean():.4e}")
    check(mae_i8 <= MASK_MAE_I8_LIMIT, f"int8 mask MAE {mae_i8:.3e} > {MASK_MAE_I8_LIMIT}")
    model_speed = None
    for tag, flags in (("int8dec", {"int8_decoder": True}),
                       ("speed", {"int8_encoder": True, "int8_decoder": True})):
        m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16", **flags))
        m.load_state_dict(state)
        pr = Predictor(None, {**model_config, **flags}, None, batch_size=4, device="cuda",
                       model=m)
        seg_t, _, launches[f"predict_{tag}"] = predict_checked(
            pr, images, 512, flags.get("int8_encoder", False), torch, int8_dec=True)
        mae_t = float(np.abs(seg_t - seg32).mean())
        log(f"predict {tag}: mask MAE vs f32 plain {mae_t:.4e} (limit {MASK_MAE_I8DEC_LIMIT}), "
            f"max {np.abs(seg_t - seg32).max():.4e}; vs bf16 kernel path "
            f"{np.abs(seg_t - seg).mean():.4e}")
        check(mae_t <= MASK_MAE_I8DEC_LIMIT,
              f"{tag}: mask MAE {mae_t:.3e} > {MASK_MAE_I8DEC_LIMIT}")
        if tag == "speed":
            model_speed = pr.model
        del pr, m

    # -- 4c. the Predictor on grids that are not 2^k ---------------------------
    x384 = seg384_32 = imgs384 = x640 = None
    for size in GRID_SIZES:
        mc = {**model_config, "image_processing": {"target_size": size}}
        pred_s = Predictor(None, mc, None, batch_size=4, device="cuda", model=model)
        imgs = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(4)]
        seg_s, _, launches[f"predict_{size}"] = predict_checked(pred_s, imgs, size, False,
                                                                 torch)
        xs = torch.from_numpy(np.stack([pred_s.processor.process_array(a)
                                        for a in imgs])).to(dev)
        seg_s32, _ = f32_masks(state, xs, torch, dev)
        mae_s = float(np.abs(seg_s - seg_s32).mean())
        log(f"predict {size}: mask MAE vs f32 plain {mae_s:.4e} (limit {MASK_MAE_LIMIT}), "
            f"max {np.abs(seg_s - seg_s32).max():.4e}")
        check(mae_s <= MASK_MAE_LIMIT, f"{size}: mask MAE {mae_s:.3e} > {MASK_MAE_LIMIT}")
        m8 = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16", int8_decoder=True))
        m8.load_state_dict(state)
        pred8 = Predictor(None, {**mc, "int8_decoder": True}, None, batch_size=4,
                          device="cuda", model=m8)
        seg8, _, launches[f"predict_{size}_int8dec"] = predict_checked(
            pred8, imgs, size, False, torch, int8_dec=True)
        mae8 = float(np.abs(seg8 - seg_s32).mean())
        log(f"predict {size} int8dec: mask MAE vs f32 plain {mae8:.4e} (limit "
            f"{MASK_MAE_I8DEC_LIMIT}), max {np.abs(seg8 - seg_s32).max():.4e}; vs bf16 kernel "
            f"path {np.abs(seg8 - seg_s).mean():.4e}")
        check(mae8 <= MASK_MAE_I8DEC_LIMIT,
              f"{size} int8dec: mask MAE {mae8:.3e} > {MASK_MAE_I8DEC_LIMIT}")
        if size == 384:
            x384, seg384_32, imgs384 = xs, seg_s32, imgs
        if size == 640:
            x640 = xs
        del pred_s, pred8, m8
    untried_routes(model, state, torch, dev, launches)
    model_f32 = f32_predict(state, images, seg32, imgs384, seg384_32, torch, launches_f32)

    # -- 5. timings at batch 8 ------------------------------------------------
    x8 = torch.cat([x, x]).to(torch.float32)
    run = {}
    with torch.inference_mode():
        for mode in ("kernel", "int8", "speed", "plain", "plain", "speed", "int8", "kernel"):
            m = {"int8": pred_i8.model, "speed": model_speed}.get(mode, model)
            model.kernels = mode != "plain"
            ms = kc.time_ms(lambda: m(x8), iters=5, warmup=2) / 8
            run.setdefault(mode, []).append(ms)
        x384_8 = torch.cat([x384, x384]).to(torch.float32)
        for mode in ("kernel_384", "speed_384", "plain_384", "plain_384", "speed_384",
                     "kernel_384"):
            m = model_speed if mode == "speed_384" else model
            model.kernels = mode != "plain_384"
            run.setdefault(mode, []).append(
                kc.time_ms(lambda: m(x384_8), iters=10, warmup=2) / 8)
        x640_8 = torch.cat([x640, x640]).to(torch.float32)
        for mode in ("kernel_640", "plain_640", "plain_640", "kernel_640"):
            model.kernels = mode == "kernel_640"
            run.setdefault(mode, []).append(
                kc.time_ms(lambda: model(x640_8), iters=5, warmup=2) / 8)
        for mode in ("kernel_f32", "plain_f32", "plain_f32", "kernel_f32"):
            model_f32.kernels = mode == "kernel_f32"
            run.setdefault(mode, []).append(
                kc.time_ms(lambda: model_f32(x8), iters=3, warmup=1) / 8)
    model.kernels = model_f32.kernels = True
    log(f"e2e f32 (use_amp: false) ms/img at batch 8, 512^2: kernel path {run['kernel_f32']}, "
        f"plain f32 path {run['plain_f32']}")
    log(f"e2e ms/img at batch 8: kernel path {run['kernel']}, int8 kernel path {run['int8']}, "
        f"speed mode (both int8 flags) {run['speed']}, plain bf16 path {run['plain']}; at "
        f"384^2: kernel path {run['kernel_384']}, speed mode {run['speed_384']}, plain bf16 "
        f"path {run['plain_384']}; at 640^2: kernel path {run['kernel_640']}, plain bf16 path "
        f"{run['plain_640']}")
    del model, predictor, model_i8, pred_i8, model_speed, model_f32
    torch.cuda.empty_cache()

    per = {w: {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
           for w in KERNELS}

    def account(row, name, k_ms, p_ms, backward=False, lib_ms=None):
        # per-forward totals: 512^2 counts, 384^2 counts for the AT_384 rows,
        # the f32 forward's at 512^2 for the f32 rows
        f32 = KERNELS[row].dtype == "f32"
        counts = kc.COUNT_F32 if f32 else kc.COUNT_384 if row in AT_384 else kc.BLOCK_COUNT
        n = counts.get(name.replace("_ties", ""), 0)
        if name in kc.I8 or name in kc.DEC_I8 or name in kc.F32_I8:
            int8_ops, flops, nbytes = kc.i8_work(name, 8)
        else:
            int8_ops = 0.0
            flops, nbytes = kc.work(name.replace("_ties", ""), 8, backward,
                                    res=row.endswith("_res"))
        b_ms, by = kc.bound_ms(flops, nbytes, int8_ops, f32=f32)
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        log(f"time {name:10s} {row:21s} batch 8: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
            f"ms{lib}, bound {b_ms:.4f} ms ({by}) (x{n} per forward"
            f"{' at 384^2' if row in AT_384 else ' in f32' if f32 else ''})")
        p = per[row]
        p["ms"] += k_ms * n
        p["plain_ms"] += p_ms * n
        p["ops_ms" if by == "operations" else "bytes_ms"] += b_ms * n
        if lib_ms is not None:
            p["library_ms"] += lib_ms * n

    # the attention rows' device time per forward (torch.profiler), beside the
    # events time of account(): [kernel, SDPA] per row, nan where a geometry
    # went unmeasured
    attn_dev = {w: [0.0, 0.0] for w in KERNELS}

    def attn_times(row, name, case, sdpa, counts):
        k_ms, s_ms = kc.time_ms(case.kernel), kc.time_ms(sdpa)
        try:
            k_dev, s_dev = kc.device_ms(case.kernel), kc.device_ms(sdpa)
        except RuntimeError as e:   # the profiler saw nothing: a reading, not a check
            log(f"device {name:10s} {row:21s}: not measured ({e})")
            attn_dev[row][0] = attn_dev[row][1] = float("nan")
            return k_ms, s_ms
        n = counts.get(name, 0)
        attn_dev[row][0] += k_dev * n
        attn_dev[row][1] += s_dev * n
        log(f"device {name:10s} {row:21s} batch 8: kernel events {k_ms:.4f} ms, device "
            f"{k_dev:.4f} ms (host-bound share {max(k_ms - k_dev, 0.0):.4f} ms); sdpa events "
            f"{s_ms:.4f} ms, device {s_dev:.4f} ms (x{n} per forward)")
        return k_ms, s_ms

    with torch.inference_mode():
        for name, make in cases.items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            if name in kc.ATTN_CASES:
                k_ms, lib_ms = attn_times(case.wrapper, name, case,
                                          sdpa_call(name, kc, torch, F, dev), kc.COUNT_384)
                account(case.wrapper, name, k_ms, kc.time_ms(case.plain), lib_ms=lib_ms)
            elif name in kc.DECODER or name in kc.DEC_EDGE:
                lib = decoder_bench.library_call(name, 8, torch.Generator().manual_seed(2), dev)
                account(case.wrapper, name, kc.time_ms(case.kernel), kc.time_ms(case.plain),
                        lib_ms=kc.time_ms(lib))
                del lib
            else:
                account(case.wrapper, name, kc.time_ms(case.kernel), kc.time_ms(case.plain))
            del case
    for name in kc.GRAD_CASES:
        if name.endswith("_ties"):
            continue
        case = kc.grad_case(name, 8, torch.Generator().manual_seed(2), dev)
        account(case.wrapper, name, kc.time_ms(case.kernel_bwd), kc.time_ms(case.plain_bwd),
                backward=True)
        del case
        torch.cuda.empty_cache()
    for name in kc.RES:
        calls = kc.res_calls(kc.res_case(name, 8, torch.Generator().manual_seed(2), dev))
        with torch.no_grad():
            account("fused_block_t_res", name, kc.time_ms(calls["fwd"]),
                    kc.time_ms(calls["fwd_plain"]))
            account("fused_block_t_bwd_res", name, kc.time_ms(calls["bwd"]),
                    kc.time_ms(calls["bwd_plain"]), backward=True)
        del calls
        torch.cuda.empty_cache()
    with torch.inference_mode():
        for name, make in kc.i8_cases().items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            account(case.wrapper, name, kc.time_ms(case.kernel), kc.time_ms(case.plain))
            del case
        for name in ("dec_i8", "dec_i8_384"):
            case = kc.dec_i8_case(name, 8, torch.Generator().manual_seed(2), dev)
            lib = decoder_bench.library_call(name, 8, torch.Generator().manual_seed(2), dev)
            account(case.wrapper, name, kc.time_ms(case.kernel),
                    kc.time_ms(case.plain, iters=3, warmup=1), lib_ms=kc.time_ms(lib))
            del case, lib
        for name, make in kc.f32_cases().items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            row = ROW[case.wrapper, "f32"]
            if name in kc.F32_ATTN_CASES:
                k_ms, lib_ms = attn_times(row, name, case, sdpa_call(name, kc, torch, F, dev),
                                          kc.COUNT_F32)
                account(row, name, k_ms, kc.time_ms(case.plain), lib_ms=lib_ms)
            else:
                account(row, name, kc.time_ms(case.kernel), kc.time_ms(case.plain))
            del case
        for name in kc.F32_I8:
            case = kc.f32_i8_case(name, 8, torch.Generator().manual_seed(2), dev)
            account(ROW[case.wrapper, "f32"], name, kc.time_ms(case.kernel),
                    kc.time_ms(case.plain))
            del case
    for row, (k_dev, s_dev) in attn_dev.items():
        if KERNELS[row].library and row.startswith("fused_attention"):
            log(f"device per forward {row}: kernel {k_dev:.4f} ms, sdpa {s_dev:.4f} ms, events "
                f"kernel {per[row]['ms']:.4f} ms, sdpa {per[row]['library_ms']:.4f} ms ("
                f"{'384^2' if row in AT_384 else '512^2 f32'})")
    torch.cuda.empty_cache()
    yardsticks(kc, kernels, F, torch, dev)
    from spegnet_tpu_torch.utils import gemm_bench, gemm_tn_bench

    with torch.inference_mode():
        gemm_bench.run(8, log)
        ho = gemm_bench.run_handoff(8, log)
        per["gemm_handoff"].update(ms=ho["kernel"], plain_ms=ho["plain"], ops_ms=ho["ops_ms"],
                                   bytes_ms=ho["bytes_ms"])
        gemm_tn_bench.run(8, log)
    gemm_bench.run_f32(8, log)
    gemm_bench.run_lnq8(8, log)
    decoder_bench.run(8, log)
    torch.cuda.empty_cache()

    # -- 6. training ------------------------------------------------------------
    master = init_weights(SPEGNet(SPEGNetConfig(variant="large")),
                          torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(11)
    b2 = synthetic_train_batch(2, rng)
    log(f"train: batch 2 canvas {b2.masks.shape[1:]}, mask sizes {b2.mask_hw.tolist()}")

    def make_trainer(batch, kernels_on, dtype="bfloat16", size=512):
        conf = train_config(batch, size)
        conf["model"]["compute_dtype"] = dtype
        m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype=dtype), kernels=kernels_on)
        m.load_state_dict(master)
        return Trainer(conf, None, device="cuda", model=m)

    grad_cosines(make_trainer, b2, 512, torch, residual_ab=True)
    residual_trunk_grads(master, b2, torch, dev)

    b8 = synthetic_train_batch(8, rng)
    step_ms, mem = {}, {}
    for path in ("kernel", "plain"):
        tr = make_trainer(8, path == "kernel")
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        stats0 = {n: b.clone() for n, b in tr.model.named_buffers() if "running" in n}
        torch.cuda.reset_peak_memory_stats()
        if path == "kernel":
            kernels.reset_launches()
        res = [tr.train_step(b8) for _ in range(3)]
        torch.cuda.synchronize()
        if path == "kernel":
            launches["train"] = dict(kernels.launches)
            want = train_launches(512, 8)
            log(f"train: launches {launches['train']} (expected {want})")
            check(launches["train"] == want, "512^2 train launches differ from the routes")
        mem[path] = torch.cuda.max_memory_allocated() / 2 ** 30
        lossv = [r["metrics"]["loss"] for r in res]
        check(all(np.isfinite(lossv)), f"{path}: non-finite losses {lossv}")
        moved = sum(int(not torch.equal(before[n], p)) for n, p in tr.model.named_parameters())
        bn_moved = sum(int(not torch.equal(stats0[n], b)) for n, b in tr.model.named_buffers()
                       if n in stats0)
        # conv biases feeding a batch-statistics BatchNorm have a gradient of
        # 0 in exact arithmetic and may stay put
        check(moved >= 0.9 * len(before) and bn_moved == len(stats0),
              f"{path}: {moved}/{len(before)} params, {bn_moved}/{len(stats0)} BN stats moved")
        res += [tr.train_step(b8) for _ in range(TIMED_STEPS - 2)]
        ms = [1e3 * (r["timing"]["forward_time"] + r["timing"]["backward_time"])
              for r in res[1:]]
        step_ms[path] = ms
        log(f"train {path} batch 8: {moved}/{len(before)} params moved, losses {lossv}, "
            f"ms/step after warm-up {[round(v, 3) for v in ms]} (median "
            f"{float(np.median(ms)):.3f}; forward "
            f"{[round(1e3 * r['timing']['forward_time'], 3) for r in res[1:]]}), "
            f"peak memory {mem[path]:.2f} GiB")
        del tr, before, res
        torch.cuda.empty_cache()

    residual_steps(make_trainer, b8, torch, launches)

    # (c) at 384^2
    grad_cosines(make_trainer, synthetic_train_batch(2, rng, 384), 384, torch)
    b8 = synthetic_train_batch(8, rng, 384)
    want = train_launches(384, 8)
    for path in ("kernel", "plain"):
        tr = make_trainer(8, path == "kernel", size=384)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        res = [tr.train_step(b8) for _ in range(3)]
        torch.cuda.synchronize()
        if path == "kernel":
            launches["train_384"] = dict(kernels.launches)
            log(f"train 384: launches {launches['train_384']} (expected {want})")
            check(launches["train_384"] == want, "384^2 train launches differ from the routes")
        lossv = [r["metrics"]["loss"] for r in res]
        check(all(np.isfinite(lossv)), f"{path} 384: non-finite losses {lossv}")
        ms = [1e3 * (r["timing"]["forward_time"] + r["timing"]["backward_time"])
              for r in res[1:]]
        log(f"train {path} 384^2 batch 8: losses {lossv}, ms/step after warm-up "
            f"{[round(v, 3) for v in ms]}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del tr, res
        torch.cuda.empty_cache()

    f32_training(make_trainer, b2, synthetic_train_batch(8, rng), torch, launches_f32)

    validation_phase(master, torch)

    # -- 7. evaluate -------------------------------------------------------------
    evaluate_phase(state, torch, dev, 512, ((False, False), (True, False), (True, True)))
    evaluate_phase(state, torch, dev, 384, ((False, False),))
    evaluate_phase(state, torch, dev, 512, ((False, False),), dtype="float32")

    # -- 8. data parallelism, remat, batch 42, sequence parallelism, the report --
    ddp_one_rank(master, torch, launches)
    ddp_two_ranks(torch, launches)
    remat_phase(master, torch, launches)
    batch42_phase(master, torch, launches)
    sp_two_ranks(torch, launches)
    tp_two_ranks(torch, launches)
    camo_edges_phase(torch)
    sp_model_four_ranks(torch, launches)
    model_report()

    jax_side = sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spegnet_tpu"))
    check(not jax_side, f"the port imported JAX-package modules: {jax_side[:5]}")

    table = []
    for w, r in KERNELS.items():
        p = per[w]
        bound = p["ops_ms"] + p["bytes_ms"]
        runs = launches_f32 if r.dtype == "f32" else launches
        table.append({"name": w, "route": "cuda", "source": r.source, "replaces": r.replaces,
                      "launches": sum(run.get(r.counter, 0) for run in runs.values()),
                      "max_abs_err": max_err[w], "ms": p["ms"], "plain_ms": p["plain_ms"],
                      "bound_ms": bound,
                      "bound_by": "operations" if p["ops_ms"] >= p["bytes_ms"] else "bytes",
                      "library_ms": p["library_ms"] if r.library else None})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def predict_checked(predictor, images, size: int, int8: bool, torch, int8_dec: bool = False,
                    dtype=None):
    """The Predictor on ``images`` with every launch counter zeroed just
    before: the counters must equal the routes of one forward in ``dtype``
    (default bf16; and decoder block 2, in the int8 mode with ``int8_dec``;
    in f32 none, as in JAX), the outputs finite and of the expected shapes.
    Returns (masks, edges, counters)."""
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
    from spegnet_tpu_torch.ops.fused_decoder import decoder_supported

    dtype = dtype or torch.bfloat16
    tag = (f"predict {size}{' int8' if int8 else ''}{' int8dec' if int8_dec else ''}"
           f"{' f32' if dtype == torch.float32 else ''}")
    kernels.reset_launches()
    seg, edge = predictor.predict_arrays(images)
    torch.cuda.synchronize()
    got = dict(kernels.launches)
    want = {w: 0 for w in kernels.launches}
    want.update(Counter(trunk_routes(HIERA_VARIANTS["large"], size // 4, dtype, int8)))
    want.pop("plain", None)
    if dtype == torch.bfloat16:
        want["fused_decoder_block_i8" if int8_dec else "fused_decoder_block"] = int(
            decoder_supported(size // 2))
    log(f"{tag}: launches {got} (expected {want})")
    check(got == want, f"{tag}: launches differ from the routes")
    got.update(kernels.gemm_launches)
    log(f"{tag}: hand-off GEMM launches {kernels.gemm_launches['gemm_handoff']}")
    n = len(images)
    check(seg.shape == (n, size, size) and edge.shape == (n, size // 8, size // 8),
          f"{tag}: output shapes {seg.shape} {edge.shape}")
    check(bool(np.isfinite(seg).all() and np.isfinite(edge).all()), f"{tag}: non-finite output")
    return seg, edge, got


def f32_masks(state, x, torch, dev):
    """Mask and edge probabilities of the plain f32 path (kernels=False) on
    the weights ``state`` for the normalized batch ``x``."""
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    anchor = SPEGNet(SPEGNetConfig(variant="large"), kernels=False)
    anchor.load_state_dict(state)
    anchor.eval().to_compute(dev)
    with torch.inference_mode():
        out = anchor(x)
        seg32 = torch.sigmoid(out["predictions"][-1].float())[..., 0].cpu().numpy()
        edge32 = torch.sigmoid(out["edge"].float())[..., 0].cpu().numpy()
    del anchor, out
    torch.cuda.empty_cache()
    return seg32, edge32


def grad_cosines(make_trainer, batch, size: int, torch, residual_ab: bool = False) -> None:
    """The batch's gradient through the kernel path, the plain bf16 path and
    the plain f32 path on the same weights; the kernel path's cosine to the
    f32 gradient, overall and for the encoder, must be no worse than the
    plain bf16 path's by more than COSINE_MARGIN.  With ``residual_ab``, also
    the kernel path under SAVE_RESIDUALS "1" and the kernel path again under
    "0", held as phase 6(d) of the module docstring says."""
    from spegnet_tpu_torch.ops import fused_block_t as fbt

    paths = {"kernel": (True, "bfloat16", "0"), "plain": (False, "bfloat16", "0"),
             "f32": (False, "float32", "0")}
    if residual_ab:
        paths.update(kernel_again=(True, "bfloat16", "0"), kernel_res=(True, "bfloat16", "1"))
    grads, losses = {}, {}
    for path, (kern, dtype, mode) in paths.items():
        tr = make_trainer(2, kern, dtype, size)
        with fbt.residuals_mode(mode):
            ld = tr.forward_loss(*tr.to_device(batch))
            ld["loss"].backward()
        losses[path] = ld["loss"].item()
        grads[path] = {n: p.grad.detach().float() for n, p in tr.model.named_parameters()}
        check(all(torch.isfinite(g).all().item() for g in grads[path].values()),
              f"{path} gradient not finite at {size}^2")
        del tr, ld
        torch.cuda.empty_cache()

    cos = {(p, grp): grad_cosine(grads[p], grads["f32"], pre) for p in ("kernel", "plain")
           for grp, pre in (("all", ""), ("encoder", "encoder."))}
    log(f"train grad {size}^2 (batch 2): loss kernel {losses['kernel']:.6f} plain bf16 "
        f"{losses['plain']:.6f} f32 {losses['f32']:.6f}")
    for grp in ("all", "encoder"):
        log(f"train grad {size}^2 cosine to f32 ({grp}): kernel {cos[('kernel', grp)]:.6f}, "
            f"plain bf16 {cos[('plain', grp)]:.6f}")
        check(cos[("kernel", grp)] >= cos[("plain", grp)] - COSINE_MARGIN,
              f"{size}^2 kernel-path gradient ({grp}) cosine {cos[('kernel', grp)]:.4f} < "
              f"plain {cos[('plain', grp)]:.4f} - {COSINE_MARGIN}")
    if residual_ab:
        to32 = {p: grad_cosine(grads[p], grads["f32"]) for p in ("kernel", "kernel_again",
                                                             "kernel_res")}
        spread = abs(to32["kernel"] - to32["kernel_again"])
        same = grad_cosine(grads["kernel_again"], grads["kernel"])
        res_to0 = grad_cosine(grads["kernel_res"], grads["kernel"])
        log(f"train grad {size}^2 saved-residual pair (batch 2): loss \"1\" "
            f"{losses['kernel_res']:.6f}; cosine to f32: \"1\" {to32['kernel_res']:.9f}, "
            f"\"0\" {to32['kernel']:.9f} / {to32['kernel_again']:.9f}; cosine \"1\" to \"0\" "
            f"{res_to0:.12f}, \"0\" to \"0\" {same:.12f}")
        log(f"train grad {size}^2: the two \"0\" runs' cosines to f32 differ by {spread:.3e}")
        check(to32["kernel_res"] >= to32["kernel"] - COSINE_MARGIN,
              f"the saved-residual gradient's cosine to f32 {to32['kernel_res']:.9f} < the "
              f"recompute path's {to32['kernel']:.9f} - {COSINE_MARGIN}")
    del grads
    torch.cuda.empty_cache()


def grad_cosine(a, b, prefix: str = "") -> float:
    """Cosine of two gradients (name -> tensor) over the parameters whose
    names start with ``prefix``."""
    dot = na = nb = 0.0
    for n in a:
        if n.startswith(prefix):
            dot += float((a[n].double() * b[n].double()).sum())
            na += float((a[n].double() ** 2).sum())
            nb += float((b[n].double() ** 2).sum())
    return dot / max(np.sqrt(na * nb), 1e-300)


def residual_trunk_grads(master, batch, torch, dev) -> None:
    """The trunk's gradients under SAVE_RESIDUALS "0" twice and "1", held
    as phase 6(d) of the module docstring says."""
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import ImageProcessor
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.ops import fused_block_t as fbt

    model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
    model.load_state_dict(master)
    model.to(dev).train()
    trunk = model.encoder.encoder
    names, params = zip(*trunk.named_parameters())
    proc = ImageProcessor(batch.images.shape[1])
    x = ((torch.from_numpy(batch.images).to(dev).float() / 255.0
          - torch.as_tensor(proc.mean, device=dev)) / torch.as_tensor(proc.std, device=dev))
    g = torch.Generator().manual_seed(23)
    cot, grads = None, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run, mode in (("0a", "0"), ("0b", "0"), ("1", "1")):
            kernels.reset_launches()
            with fbt.residuals_mode(mode):
                feats = trunk(x, kernels=True, dtype=torch.bfloat16)
                if cot is None:
                    cot = [torch.randn(f.shape, generator=g).to(dev, f.dtype) for f in feats]
                grads[run] = [t.float() for t in torch.autograd.grad(feats, params, cot)]
            torch.cuda.synchronize()
            pair = kernels.launches["fused_block_t_bwd_res"]
            check(pair == (42 if mode == "1" else 0),
                  f"trunk under SAVE_RESIDUALS={mode}: {pair} blocks on the pair")
            del feats
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / max(float(a.norm() * b.norm()), 1e-300))

    varies, differ = [], []
    for name, g0, g0b, g1 in zip(names, grads["0a"], grads["0b"], grads["1"]):
        if torch.equal(g0, g0b):
            if not torch.equal(g1, g0):
                differ.append((name, int((g1 != g0).sum())))
        else:
            varies.append((name, cos(g1, g0), cos(g0b, g0)))
    log(f"train trunk grads 512^2 (batch 2, one cotangent, cuDNN deterministic): "
        f"{len(names) - len(varies)} of {len(names)} parameters equal across two \"0\" runs, "
        f"of them {len(differ)} differ under \"1\" {differ[:5]}; the others (cosine \"1\" "
        f"to \"0\", \"0\" to \"0\"): {varies}")
    check(not differ, f"the saved-residual pair changed trunk gradients: {differ[:5]}")
    check(all(c1 >= c0 - RES_COS_SLACK for _, c1, c0 in varies),
          f"a varying trunk gradient moved under the pair: {varies}")
    del model, trunk, grads
    torch.cuda.empty_cache()


def residual_steps(make_trainer, batch, torch, launches) -> None:
    """One Trainer at 512^2 on ``batch``: 3 steps under each SAVE_RESIDUALS
    mode (every launch counter equal to three times the training routes,
    peak memory), then RES_ROUNDS rounds of one step per mode in rotating
    order, so each mode's step is timed beside the others' on the same
    model and allocator state; each mode against "0": its median step
    difference and the rounds it is faster in."""
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.ops import fused_block_t as fbt

    b = batch.images.shape[0]
    tr = make_trainer(b, True)
    for mode in RES_MODES:
        with fbt.residuals_mode(mode):
            want = train_launches(512, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            res = [tr.train_step(batch) for _ in range(3)]
            torch.cuda.synchronize()
            got = dict(kernels.launches)
        lossv = [r["metrics"]["loss"] for r in res]
        check(all(np.isfinite(lossv)), f"SAVE_RESIDUALS={mode}: non-finite losses {lossv}")
        check(got == want, f"SAVE_RESIDUALS={mode}: launches {got} differ from the training "
                           f"routes {want}")
        launches.setdefault(f"train_res_{mode}", got)
        log(f"train SAVE_RESIDUALS={mode} batch {b}: launches {got}, losses {lossv}, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    ms = {mode: [] for mode in RES_MODES}
    for r in range(RES_ROUNDS):
        for mode in RES_MODES[r % 3:] + RES_MODES[:r % 3]:
            with fbt.residuals_mode(mode):
                t = tr.train_step(batch)["timing"]
            ms[mode].append(1e3 * (t["forward_time"] + t["backward_time"]))
    for mode in RES_MODES:
        line = (f"train SAVE_RESIDUALS={mode} 512^2 batch {b}: ms/step "
                f"{[round(v, 3) for v in ms[mode]]} (median {np.median(ms[mode]):.3f})")
        if mode != "0":
            diff = np.subtract(ms[mode], ms["0"])
            line += (f"; against \"0\" in the same round: median {np.median(diff):+.3f} ms, "
                     f"faster in {int((diff < 0).sum())} of {RES_ROUNDS}")
        log(line)
    del tr
    torch.cuda.empty_cache()


def train_launches(size: int, batch: int, steps: int = 3, dtype=None, sp=None):
    """Every launch counter after ``steps`` Trainer steps of ``batch`` images
    at ``size``^2 in compute dtype ``dtype`` (default bf16): the training
    routes (models/hiera.trunk_routes under the current SAVE_RESIDUALS, and
    a spatial axis of size ``sp``) forward, and in bf16 backward (in f32 the
    backwards recompute through the plain versions, as in JAX, and count
    nothing)."""
    import torch

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes

    dtype = dtype or torch.bfloat16
    want = {w: 0 for w in kernels.launches}
    for w, n in Counter(trunk_routes(HIERA_VARIANTS["large"], size // 4, dtype, False,
                                     train_batch=batch, sp=sp)).items():
        if w not in ("plain", "global_ref"):
            want[w] = steps * n
            bwd = w.replace("_res", "") + "_bwd" + ("_res" if w.endswith("_res") else "")
            if bwd in want and dtype == torch.bfloat16:
                want[bwd] = steps * n
    return want


def f32_checks(kc, torch, dev, max_err) -> None:
    """Phase 3 in f32: every f32 kernel against its plain f32 version at
    every f32 main-path geometry, batch 2, within kc.F32_REL_LIMIT; the int8
    gen-1 block on f32 by the int8 rule (a code that crosses a rounding edge
    moves its output by a dequant step) and its pieces by kc.i8_parts_ok;
    the f32 GEMM alone at every f32 gen-1 product and a ragged shape, and
    the int8 LayerNorm + quant alone at every LNQ8 geometry."""
    for name, make in kc.f32_cases().items():
        case = make(name, 2, torch.Generator().manual_seed(1), dev)
        err, rel = kc.compare(case)
        torch.cuda.synchronize()
        row = ROW[case.wrapper, "f32"]
        max_err[row] = max(max_err[row], err)
        log(f"check {name:14s} {row:26s} max_abs {err:.4e} rel {rel:.4e} "
            f"(limit {kc.F32_REL_LIMIT})")
        check(rel <= kc.F32_REL_LIMIT, f"{name}: f32 kernel disagrees with plain f32 ({rel:.3e})")
        del case
    for name in kc.F32_I8:
        case = kc.f32_i8_case(name, 2, torch.Generator().manual_seed(1), dev)
        res = kc.compare_i8(case)
        torch.cuda.synchronize()
        row = ROW[case.wrapper, "f32"]
        max_err[row] = max(max_err[row], res["max_abs"])
        log(f"check {name:14s} {row:26s} max_abs {res['max_abs']:.4e} rel {res['rel']:.4e} "
            f"(limits {kc.I8_MAX}, {kc.REL_LIMIT}); elements beyond {kc.I8_ATOL}: "
            f"{res['frac_strict']:.4%}")
        check(kc.i8_ok(res), f"{name}: f32 int8 kernel disagrees with plain int8 ({res})")
        parts = kc.i8_parts(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:14s} int8 pieces: {parts} (limits share {kc.I8_PART_FRAC}, one code; "
            f"row quant and GEMM without GELU exact; GELU rel {kc.I8_F32_GELU_REL})")
        check(kc.i8_parts_ok(parts), f"{name}: an f32 int8 piece disagrees ({parts})")
        del case
    for name, (m, n, k, _, _) in kc.gemm_f32_shapes(2).items():
        res = kc.compare_gemm_f32(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:20s} gemm_f32 M {m} N {n} K {k}: rel {res['rel']:.3e} (limit "
            f"{kc.F32_REL_LIMIT}), two calls bit-equal {res['same']}")
        check(kc.gemm_f32_ok(res), f"{name}: the f32 GEMM disagrees with plain f32 ({res})")
    for name, (c, _, f32, _) in kc.LNQ8.items():
        res = kc.compare_lnq8(name, 2, torch.Generator().manual_seed(1), dev)
        torch.cuda.synchronize()
        log(f"check {name:10s} layernorm_q8 C {c} {'f32' if f32 else 'bf16'}: {res} (limits "
            f"share {kc.I8_PART_FRAC}, one code, scale rel {kc.LNQ8_SCALE_REL[f32]:.3g})")
        check(kc.lnq8_ok(res, f32), f"{name}: layernorm_q8 disagrees with plain ({res})")
    torch.cuda.empty_cache()


def tn_checks(kc, kernels, torch, dev) -> None:
    """Phase 3's weight-gradient GEMM: kernels.gemm_tn at every weight
    gradient of the kernel backwards (kc.tn_shapes, batch 2) against its
    plain version within TN_REL_LIMIT, gradient and column sums, two calls
    bit-equal."""
    from spegnet_tpu_torch.ops.fused_block_t import weight_grad

    for name, (m, n, k) in kc.tn_shapes(2).items():
        g = torch.Generator().manual_seed(m + n + k)
        a = torch.randn((m, n), generator=g).to(dev, torch.bfloat16)
        b = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
        out, cs = kernels.gemm_tn(a, b)
        out2, cs2 = kernels.gemm_tn(a, b)
        want, want_cs = weight_grad(a, b)
        torch.cuda.synchronize()
        rel = max(float((out - want).abs().max() / want.abs().max()),
                  float((cs - want_cs).abs().max() / want_cs.abs().max()))
        same = torch.equal(out, out2) and torch.equal(cs, cs2)
        log(f"check {name:11s} gemm_tn M {m} N {n} K {k}: rel {rel:.2e} (limit {TN_REL_LIMIT}),"
            f" two calls bit-equal {same}")
        check(rel <= TN_REL_LIMIT and same, f"{name}: gemm_tn disagrees ({rel:.3e}, {same})")
    torch.cuda.empty_cache()


def f32_predict(state, images, seg32, imgs384, seg384_32, torch, launches):
    """Phase 4 in f32 (use_amp: false): the Predictor at 512^2 and 384^2
    (batch 4) on the f32 kernel path, every launch counter equal to the f32
    routes (JAX's: gen-1 blocks and fused_attention_lanes, no T-block, no
    front, decoder block 2 decomposed), mask MAE against the plain f32 path
    <= MASK_MAE_F32_LIMIT; then with int8_encoder at 512^2 (the int8 gen-1
    block on f32), MAE <= MASK_MAE_I8_LIMIT.  Returns the f32 model."""
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="float32"))
    model.load_state_dict(state)
    for size, imgs, ref, int8 in ((512, images, seg32, False), (384, imgs384, seg384_32, False),
                                  (512, images, seg32, True)):
        mc = {"encoder": {"variant": "large"}, "compute_dtype": "float32", "int8_encoder": int8,
              "image_processing": {"target_size": size}}
        m = model
        if int8:
            m = SPEGNet(SPEGNetConfig.from_dict(mc))
            m.load_state_dict(state)
        pred = Predictor(None, mc, None, batch_size=4, device="cuda", model=m)
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "an f32 Predictor left TF32 on")
        tag = f"{size}{'_int8' if int8 else ''}"
        seg, _, launches[f"predict_{tag}"] = predict_checked(pred, imgs, size, int8, torch,
                                                              dtype=torch.float32)
        mae = float(np.abs(seg - ref).mean())
        limit = MASK_MAE_I8_LIMIT if int8 else MASK_MAE_F32_LIMIT
        log(f"predict f32 {tag}: mask MAE vs f32 plain {mae:.4e} (limit {limit}), max "
            f"{np.abs(seg - ref).max():.4e}")
        check(mae <= limit, f"f32 {tag}: mask MAE {mae:.3e} > {limit}")
        del pred, m
    torch.cuda.empty_cache()
    return model


def f32_training(make_trainer, b2, b8, torch, launches) -> None:
    """Phase 6 in f32 (use_amp: false), 512^2: the batch-2 gradient through
    the f32 kernel path against the plain f32 path, cosine >=
    COSINE_F32_LIMIT for the whole model and the encoder; then 3 Trainer
    steps at batch 8 on each path: every launch counter of the kernel path
    equal to three times the f32 routes with no backward counter moving
    (the f32 backwards recompute through the plain versions, as in JAX),
    losses finite; ms/step (the two steps after the first) and peak
    memory."""
    from spegnet_tpu_torch import kernels

    grads = {}
    for path in ("kernel", "plain"):
        tr = make_trainer(2, path == "kernel", "float32")
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "an f32 Trainer left TF32 on")
        ld = tr.forward_loss(*tr.to_device(b2))
        ld["loss"].backward()
        grads[path] = {n: p.grad.detach().float() for n, p in tr.model.named_parameters()}
        check(all(torch.isfinite(g).all().item() for g in grads[path].values()),
              f"f32 {path} gradient not finite")
        del tr, ld
        torch.cuda.empty_cache()
    for grp, pre in (("all", ""), ("encoder", "encoder.")):
        cos = grad_cosine(grads["kernel"], grads["plain"], pre)
        log(f"train f32 grad 512^2 (batch 2) cosine kernel path to plain f32 ({grp}): "
            f"{cos:.9f} (limit {COSINE_F32_LIMIT})")
        check(cos >= COSINE_F32_LIMIT, f"f32 gradient ({grp}) cosine {cos:.6f}")
    del grads
    for path in ("kernel", "plain"):
        tr = make_trainer(8, path == "kernel", "float32")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        res = [tr.train_step(b8) for _ in range(3)]
        torch.cuda.synchronize()
        if path == "kernel":
            launches["train"] = dict(kernels.launches)
            want = train_launches(512, 8, dtype=torch.float32)
            log(f"train f32: launches {launches['train']} (expected {want})")
            check(launches["train"] == want, "f32 train launches differ from the routes")
        lossv = [r["metrics"]["loss"] for r in res]
        check(all(np.isfinite(lossv)), f"f32 {path}: non-finite losses {lossv}")
        ms = [1e3 * (r["timing"]["forward_time"] + r["timing"]["backward_time"])
              for r in res[1:]]
        log(f"train f32 {path} 512^2 batch 8: losses {lossv}, ms/step after warm-up "
            f"{[round(v, 3) for v in ms]}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del tr, res
        torch.cuda.empty_cache()


def validation_phase(master, torch) -> None:
    """One epoch of Trainer.train with validation on 12 seeded 512^2 PNG
    samples (val_ratio 0.25) in a temporary directory, as phase 6(e) of the
    module docstring says."""
    import tempfile

    from spegnet_tpu_torch.data.dataset import concat_train_datasets, train_val_split
    from spegnet_tpu_torch.data.pipeline import val_loader
    from spegnet_tpu_torch.data.png import write_png
    from spegnet_tpu_torch.engine.model_loader import load_checkpoint
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.losses import resize_logits_to_canvas
    from spegnet_tpu_torch.metrics.torch_metrics import (
        compute_batch_metrics,
        quantize_predictions,
    )
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    rng = np.random.default_rng(19)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "synthetic"
        for sub in ("Imgs", "GT", "Edges"):
            (root / "train" / sub).mkdir(parents=True)
        yy, xx = np.mgrid[:512, :512]
        for i in range(12):
            cy, cx, ry, rx = rng.uniform(160, 352, 2).tolist() + rng.uniform(50, 150, 2).tolist()
            m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1
            p = np.pad(m, 1)
            edge = m & ~(p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:])
            img = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
            img[m] = (img[m] * 0.5 + 90).astype(np.uint8)
            write_png(root / "train" / "Imgs" / f"s{i:02d}.png", img)
            write_png(root / "train" / "GT" / f"s{i:02d}.png", m.astype(np.uint8) * 255)
            write_png(root / "train" / "Edges" / f"s{i:02d}.png", edge.astype(np.uint8) * 255)
        conf = train_config(8)
        conf["training"].update(val_ratio=0.25, save_freq=100)
        model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
        model.load_state_dict(master)
        dm = DirectoryManager("train", base_dir=str(Path(tmp) / "results"))
        tr = Trainer(conf, dm, device="cuda", model=model)
        captured = []
        hook = tr.model.register_forward_hook(
            lambda mod, inp, out: None if mod.training else captured.append(
                (out["predictions"][-1].detach().float(), out["edge"].detach().float())))
        t0 = time.perf_counter()
        tr.train([str(root)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hook.remove()
        hist = json.loads(dm.run_dirs.metrics_file.read_text())
        check(len(hist["epochs"]) == 1 and "val" in hist["epochs"][0],
              f"validation did not run: {hist}")
        val = hist["epochs"][0]["val"]
        keys = ("loss", "seg_loss", "edge_loss", "s_alpha", "weighted_f", "mae", "e_phi",
                "mean_f", "edge_mae", "edge_f")
        check(all(np.isfinite(val["metrics"][k]) for k in keys), f"val metrics {val}")
        best = dm.run_dirs.checkpoints / "model_best.pth"
        check(best.exists(), f"no model_best.pth (val weighted F {val['metrics']['weighted_f']})")
        state, config = load_checkpoint(str(best))
        SPEGNet(SPEGNetConfig.from_dict(config["model"])).load_state_dict(state, strict=True)

        _, val_ds = train_val_split(concat_train_datasets([str(root)]), 0.25)
        batches = list(val_loader(val_ds, tr.processor, 8, tr.buckets, num_workers=0))
        check(len(captured) == len(batches) == 1 and len(val_ds) == 3,
              f"{len(captured)} validation forwards for {len(batches)} batches")
        dev = torch.device("cuda")
        rows = {"card": {}, "cpu": {}}
        for (logits, edge_logits), b in zip(captured, batches):
            masks, edges, mask_hw, edge_hw, dst, idx = (
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (b.masks, b.edges, b.mask_hw, b.edge_hw, b.dst, b.nearest_idx))
            canvas = tuple(masks.shape[1:3])
            pred_c, valid = resize_logits_to_canvas(logits, mask_hw, canvas)
            edge_c, evalid = resize_logits_to_canvas(edge_logits, edge_hw, canvas)
            q, qe = quantize_predictions(pred_c), quantize_predictions(edge_c)
            for where, put in (("card", lambda t: t), ("cpu", lambda t: t.cpu())):
                seg = compute_batch_metrics(put(q), put(masks), put(valid), put(mask_hw),
                                            put(dst), put(idx))
                edge = compute_batch_metrics(put(qe), put(edges), put(evalid), put(edge_hw))
                for key, v in (("s_alpha", seg["sm"]), ("weighted_f", seg["wfm"]),
                               ("mae", seg["mae"]), ("e_phi", seg["em"]),
                               ("mean_f", seg["fm"]), ("edge_mae", edge["mae"]),
                               ("edge_f", edge["fm"])):
                    rows[where].setdefault(key, []).append(v.cpu().double())
        gap = {k: float((torch.cat(rows["card"][k]) - torch.cat(rows["cpu"][k])).abs().max())
               for k in rows["card"]}
        logged = {k: abs(float(torch.cat(rows["card"][k]).mean()) - val["metrics"][k])
                  for k in rows["card"]}
        log(f"validation 512^2 (12 PNG samples, 9 train / 3 val, batch 8): one epoch "
            f"{secs:.2f} s with the build of the val batch; val metrics {val['metrics']}; "
            f"val ms per batch {1e3 * val['timing']['batch_time']:.3f}, val epoch "
            f"{val['timing']['epoch_time']:.3f} s; model_best.pth loads")
        log(f"validation: card vs CPU metrics on the same u8 predictions, max |diff| "
            f"{max(gap.values()):.3e} (limit {METRIC_TOL}; by metric {gap}); vs the logged "
            f"val metrics {max(logged.values()):.3e}")
        check(max(gap.values()) <= METRIC_TOL, f"validation: card metrics differ from CPU {gap}")
        check(max(logged.values()) <= METRIC_TOL, f"validation: logged metrics differ {logged}")
    del tr, model
    torch.cuda.empty_cache()


def untried_routes(model, state, torch, dev, launches) -> None:
    """The Predictor at 1024^2 (batch 2: the three global blocks, L 4096, on
    fused_block_t) and at 768^2 with int8_encoder (batch 4): launches equal
    to the routes, mask MAE against the f32 plain path."""
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    rng = np.random.default_rng(17)
    for size, batch, int8, limit in ((1024, 2, False, MASK_MAE_LIMIT),
                                     (768, 4, True, MASK_MAE_I8_LIMIT)):
        mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
              "int8_encoder": int8, "image_processing": {"target_size": size}}
        m = model
        if int8:
            m = SPEGNet(SPEGNetConfig.from_dict(mc))
            m.load_state_dict(state)
        pred = Predictor(None, mc, None, batch_size=batch, device="cuda", model=m)
        imgs = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(batch)]
        tag = f"{size}{'_int8' if int8 else ''}"
        seg, _, launches[f"predict_{tag}"] = predict_checked(pred, imgs, size, int8, torch)
        xs = torch.from_numpy(np.stack([pred.processor.process_array(a) for a in imgs])).to(dev)
        seg32, _ = f32_masks(state, xs, torch, dev)
        mae = float(np.abs(seg - seg32).mean())
        log(f"predict {tag} batch {batch}: mask MAE vs f32 plain {mae:.4e} (limit {limit}), "
            f"max {np.abs(seg - seg32).max():.4e}")
        check(mae <= limit, f"{tag}: mask MAE {mae:.3e} > {limit}")
        del pred, m, xs
        torch.cuda.empty_cache()


def sdpa_call(name: str, kc, torch, F, dev):
    """F.scaled_dot_product_attention on the q / k / v of attention geometry
    ``name`` (bf16, or f32 for a geometry of kc.F32_ATTN_CASES) at batch 8
    (heads-major views of one packed qkv)."""
    from spegnet_tpu_torch.ops.pallas_attention import split_qkv

    f32 = name in kc.F32_ATTN_CASES
    l = (kc.F32_ATTN_CASES if f32 else kc.ATTN_CASES)[name][1]
    per_image, heads, d = kc.ATTN[l]
    qkv = torch.randn((8 * per_image, l, 3 * heads * d),
                      generator=torch.Generator().manual_seed(2)).to(
                          dev, torch.float32 if f32 else torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in split_qkv(qkv, heads))
    return lambda: F.scaled_dot_product_attention(q, k, v)


def evaluate_phase(state, torch, dev, size: int, flags, dtype: str = "bfloat16") -> None:
    """The Evaluator in memory on 8 synthetic samples at ``size`` in compute
    dtype ``dtype``, for each (int8_encoder, int8_decoder) pair of ``flags``;
    the card's metrics against the CPU's on the same quantized predictions."""
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch
    from spegnet_tpu_torch.engine.evaluator import METRIC_KEYS, Evaluator
    from spegnet_tpu_torch.losses import resize_logits_to_canvas
    from spegnet_tpu_torch.metrics.torch_metrics import (
        compute_batch_metrics,
        quantize_predictions,
    )
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    batch = synthetic_eval_batch(8, np.random.default_rng(13), size)
    log(f"evaluate {size}^2: 8 samples, canvas {batch.masks.shape[1:]}, sizes "
        f"{batch.mask_hw.tolist()}")
    for int8, int8_dec in flags:
        mc = {"encoder": {"variant": "large"}, "compute_dtype": dtype,
              "int8_encoder": int8, "int8_decoder": int8_dec,
              "image_processing": {"target_size": size}}
        model = SPEGNet(SPEGNetConfig.from_dict(mc))
        model.load_state_dict(state)
        ev = Evaluator(None, None, mc, batch_size=8, device="cuda", model=model)
        means = ev.evaluate(None, "synthetic", loader=[batch, batch])
        t = ev.summaries["synthetic"]["timing"]
        tag = f"{size}^2 " + {(False, False): "bf16", (True, False): "int8",
                              (False, True): "int8dec", (True, True): "speed"}[(int8, int8_dec)]
        if dtype == "float32":
            tag = f"{size}^2 f32"
            check(not torch.backends.cuda.matmul.allow_tf32
                  and not torch.backends.cudnn.allow_tf32, "f32 evaluate left TF32 on")
        log(f"evaluate {tag}: means {means}; forward {t['forward_ms_per_image']:.3f} ms/img, "
            f"metrics {t['metrics_ms_per_image']:.3f} ms/img (batch 8, the batch twice after "
            f"one warm-up pass; per batch: forward {t['forward_ms']} ms, metrics "
            f"{t['metrics_ms']} ms)")
        rows = ev.sample_metrics["synthetic"]
        check(len(rows) == 8 and t["total_samples"] == 16
              and all(0.0 <= r[k] <= 1.0 and np.isfinite(r[k])
                      for r in rows.values() for k in METRIC_KEYS),
              f"evaluate {tag}: metrics out of range {rows}")
        arrays = [torch.from_numpy(a) for a in (batch.masks, batch.mask_hw, batch.dst,
                                                batch.nearest_idx)]
        with torch.inference_mode():
            out = ev.model(torch.from_numpy(batch.images).to(dev))
            hw = arrays[1].to(dev)
            pred_c, valid = resize_logits_to_canvas(out["predictions"][-1].float(), hw,
                                                    tuple(batch.masks.shape[1:]))
            q = quantize_predictions(pred_c)
            card = compute_batch_metrics(q, arrays[0].to(dev), valid, hw,
                                         arrays[2].to(dev), arrays[3].to(dev))
            cpu = compute_batch_metrics(q.cpu(), arrays[0], valid.cpu(), *arrays[1:])
        diffs = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in card}
        worst = max(diffs.values())
        log(f"evaluate {tag}: card vs CPU metrics on the same u8 predictions, max |diff| "
            f"{worst:.3e} (limit {METRIC_TOL}; by metric {diffs})")
        check(worst <= METRIC_TOL, f"evaluate {tag}: card metrics differ from CPU ({worst})")
        del model, ev, out
        torch.cuda.empty_cache()


def yardsticks(kc, kernels, F, torch, dev) -> None:
    """The window attention at every geometry of a 512^2 forward
    (utils/window_attention_bench.py), and each sub-kernel of the stage-1
    and global block geometries, at batch 8, beside the one PyTorch call
    that computes the same function (timed here, never called by the
    port)."""
    from spegnet_tpu_torch.utils import attention_bwd_bench, window_attention_bench

    window_attention_bench.run(8, log, choices=False)
    attention_bwd_bench.geometries(argparse.Namespace(batch=8, old=None, rounds=3), log)
    Cols = kernels.Cols
    for name in ("stage1", "global"):
        _, c, heads, l, n = kc.BLOCKS[name]
        g = torch.Generator().manual_seed(3)
        wts = kc.block_weights(c, heads, g, dev)
        d = c // heads
        m = 8 * n
        x = torch.randn((m, c), generator=g).to(dev, torch.bfloat16)
        qkv = kernels.gemm(x, wts.wqkv, wts.bqkv)
        a, lse = kernels.window_attention(qkv, heads, d, l, d ** -0.5, with_lse=True)
        da = torch.randn_like(a)
        dqkv = torch.empty_like(qkv)
        q4 = qkv.reshape(m // l, l, 3, heads, d).permute(2, 0, 3, 1, 4)
        q4 = [t.contiguous().requires_grad_() for t in q4]
        sdpa_out = F.scaled_dot_product_attention(*q4)
        g4 = da.reshape(m // l, l, heads, d).permute(0, 2, 1, 3).contiguous()
        lnw, lnb = wts.ln1_w, wts.ln1_b
        xg = x.detach().requires_grad_()
        ln_out = F.layer_norm(xg, (c,), lnw.to(torch.bfloat16), lnb.to(torch.bfloat16), 1e-6)
        pairs = {
            "gemm qkv": (lambda: kernels.gemm(x, wts.wqkv, wts.bqkv),
                         lambda: F.linear(x, wts.wqkv, wts.bqkv)),
            "attention": (lambda: kernels.window_attention(qkv, heads, d, l, d ** -0.5),
                          lambda: F.scaled_dot_product_attention(*[t.detach() for t in q4])),
            "attention bwd": (lambda: kernels.attention_bwd(
                Cols(qkv, 0), Cols(qkv, c), Cols(qkv, 2 * c), Cols(a), Cols(da), lse,
                Cols(dqkv, 0), Cols(dqkv, c), Cols(dqkv, 2 * c), heads, d, l, l, d ** -0.5),
                lambda: torch.autograd.grad(sdpa_out, q4, g4, retain_graph=True)),
            "layernorm": (lambda: kernels.layernorm(x, lnw, lnb, 1e-6),
                          lambda: F.layer_norm(x, (c,), lnw.to(torch.bfloat16),
                                               lnb.to(torch.bfloat16), 1e-6)),
            "layernorm bwd": (lambda: kernels.layernorm_bwd(x, lnw, x, 1e-6),
                              lambda: torch.autograd.grad(ln_out, xg, x, retain_graph=True)),
        }
        for what, (k, lib) in pairs.items():
            log(f"yardstick {name:7s} {what:14s} batch 8: kernel {kc.time_ms(k):.4f} ms, "
                f"library {kc.time_ms(lib):.4f} ms")
        del q4, sdpa_out, ln_out, xg
        torch.cuda.empty_cache()
    # the int8 GEMM of stage 3's fc1 (M 8192, N 2304, K 576) against cuBLASLt's
    _, c, _, _, n = kc.BLOCKS["stage3"]
    g = torch.Generator().manual_seed(4)
    a = torch.randint(-127, 128, (8 * n, c), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (4 * c, c), generator=g, dtype=torch.int8).to(dev)
    sa = torch.rand(8 * n, generator=g).to(dev)
    sw, bias = torch.rand(4 * c, generator=g).to(dev), torch.zeros(4 * c, device=dev)
    mine = kernels.gemm_i8(a, sa, w, sw, bias, gelu=True)
    exact = torch.matmul(a.double(), w.double().t())
    lib = torch._int_mm(a, w.t())
    check(torch.equal(lib.double(), exact), "torch._int_mm disagrees with the exact sum")
    ref = torch.nn.functional.gelu((exact.float() * sw * sa[:, None]), approximate="tanh")
    err = float((mine.float() - ref).abs().max() / ref.abs().max())
    ops = 2.0 * 8 * n * c * 4 * c
    k_ms, l_ms = kc.time_ms(lambda: kernels.gemm_i8(a, sa, w, sw, bias, gelu=True)), \
        kc.time_ms(lambda: torch._int_mm(a, w.t()))
    log(f"yardstick stage3  int8 gemm fc1  batch 8: kernel {k_ms:.4f} ms "
        f"({ops / k_ms / 1e9:.1f} TOPS, dequant + GELU epilogue, rel err {err:.2e}), "
        f"library torch._int_mm {l_ms:.4f} ms ({ops / l_ms / 1e9:.1f} TOPS, int32 out)")
    # the f32 gen-1 chain's pieces against F.linear / SDPA / F.layer_norm in f32
    from spegnet_tpu_torch.ops.pallas_attention import attend_windows

    for name in ("stage1_f32", "stage2_f32", "stage4_f32"):
        c, heads, l, n = kc.F32_BLOCKS[name]
        g = torch.Generator().manual_seed(5)
        wts = kc.block_weights(c, heads, g, dev, torch.float32)
        d, m = c // heads, 8 * n
        x = torch.randn((m, c), generator=g).to(dev)
        qkv = kernels.gemm_f32(x, wts.wqkv, wts.bqkv)
        q4 = [t.contiguous() for t in qkv.reshape(m // l, l, 3, heads, d).permute(2, 0, 3, 1, 4)]
        pairs = {
            "gemm qkv": (lambda: kernels.gemm_f32(x, wts.wqkv, wts.bqkv),
                         lambda: F.linear(x, wts.wqkv, wts.bqkv), 2.0 * m * c * 3 * c),
            "gemm fc1 gelu": (lambda: kernels.gemm_f32(x, wts.wfc1, wts.bfc1, gelu="erf"),
                              lambda: F.linear(x, wts.wfc1, wts.bfc1), 2.0 * m * c * 4 * c),
            "attention": (lambda: attend_windows(qkv, heads, l, d ** -0.5),
                          lambda: F.scaled_dot_product_attention(*q4), 4.0 * m * l * c),
            "layernorm": (lambda: kernels.layernorm_f32(x, wts.ln1_w, wts.ln1_b, 1e-6),
                          lambda: F.layer_norm(x, (c,), wts.ln1_w, wts.ln1_b, 1e-6), 0.0),
        }
        for what, (k, lib, flops) in pairs.items():
            k_ms, l_ms = kc.time_ms(k), kc.time_ms(lib)
            rate = (f" ({flops / k_ms / 1e9:.1f} vs {flops / l_ms / 1e9:.1f} TFLOP/s)"
                    if flops else "")
            log(f"yardstick {name:10s} {what:14s} f32 batch 8: kernel {k_ms:.4f} ms, library "
                f"{l_ms:.4f} ms{rate}")
        del q4, qkv
        torch.cuda.empty_cache()


# -- 8. data parallelism, remat, the config's batch, the model report ----------

# Tolerances of the 2-rank step against the 1-rank step on the same global
# batch (phase 8b): 2.5x the worst reading of the first chip run (an H100
# 80GB HBM3 at 700 W: loss 6.0e-8 relative, cosine 1 - 1.007e-3, update
# 0.1314, running statistics 2.885e-6), the convention of the backward
# limit (PERF.md section 2).  The two steps differ by summation order (the
# BatchNorm statistics summed over the ranks, the gradients' all-reduce) and
# by the atomics of the bilinear upsample backward, which make two runs of
# one step differ too; AdamW's first step, lr * g / (|g| + eps), turns the
# small gradients' noise into a tenth of the update.
DDP_LOSS_REL_LIMIT = 1.5e-7
DDP_COSINE_LIMIT = 1 - 2.5e-3
DDP_UPDATE_REL_LIMIT = 0.33
DDP_STATS_REL_LIMIT = 7.2e-6
RANK_TIMEOUT = 420   # seconds the spawned ranks of phase 8b-8d may take
# Slack of the whole model's gradient cosine, remat against off, below that
# of two off runs (phase 8e): they differ by the order of atomic adds only.
REMAT_COS_SLACK = 1e-4
PEAK_LIMIT_GB = 80.0


def master_state(torch):
    """Phase 6's weights: seeded random Hiera-L SPEGNet (CPU init)."""
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    return init_weights(SPEGNet(SPEGNetConfig(variant="large")),
                        torch.Generator().manual_seed(0)).state_dict()


def bf16_model(master):
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
    m.load_state_dict(master)
    return m


def phase8_batches():
    """The train batches of phase 8 (8 and its first 7 samples) and the eval
    batch (8 samples whose ground truths all fit the 512 canvas)."""
    import dataclasses

    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch, synthetic_train_batch

    b8 = synthetic_train_batch(8, np.random.default_rng(23))
    b7 = dataclasses.replace(b8, **{f.name: getattr(b8, f.name)[:7]
                                    for f in dataclasses.fields(b8) if f.name != "sample_w"})
    ev = synthetic_eval_batch(8, np.random.default_rng(29), 512, gt_range=(384, 512),
                              buckets=(512,))
    return b8, b7, ev


def step_capture(trainer, batch, torch, raw: bool = False):
    """One Trainer step -> (global loss, the clipped gradients (with
    ``raw``: the reduced gradients before the clip), updated parameters, BN
    running statistics, launch counts)."""
    from spegnet_tpu_torch import kernels

    grads = {}
    hold = (trainer, "clip_and_step") if raw else (trainer.optimizer, "step")
    call = getattr(*hold)

    def captured(*a, **k):
        grads.update({n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()})
        return call(*a, **k)

    setattr(*hold, captured)
    kernels.reset_launches()
    res = trainer.train_step(batch)
    delattr(*hold)   # no cycle through the closure: the trainer frees when dropped
    torch.cuda.synchronize()
    return {"loss": res["metrics"]["loss"], "rows": res["rows"], "grads": grads,
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            "stats": {n: b.clone() for n, b in trainer.model.named_buffers() if "running" in n},
            "launches": dict(kernels.launches)}


def step_readings(a, b, start):
    """How far step ``a`` is from step ``b`` (the reference), both from the
    weights ``start``: the loss, the clipped gradients' cosine, the
    parameter update (|pa - pb| / |pb - p0| over all parameters) and the BN
    running statistics (max |diff| / max |b|)."""
    du = ub = 0.0
    for n, pb in b["params"].items():
        p0 = start[n]
        du += float(((a["params"][n].double() - pb.double()) ** 2).sum())
        ub += float(((pb.double() - p0.double()) ** 2).sum())
    stats = max(float((a["stats"][n] - s).abs().max() / s.abs().max().clamp(min=1e-30))
                for n, s in b["stats"].items())
    return {"loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_cosine": grad_cosine(a["grads"], b["grads"]),
            "update_rel": float(np.sqrt(du / max(ub, 1e-300))), "stats_rel": stats}


def ddp_one_rank(master, torch, launches) -> None:
    """8a: a Trainer under DistributedDataParallel with one rank over NCCL
    against the plain Trainer, same weights, 512^2 batch 8: the loss
    bit-equal, every gradient bucket unchanged by the reduction, and the
    plain Trainer's clip and AdamW on the DDP step's gradients giving the
    DDP step's parameters and running statistics bit for bit (0 tensors
    differ).  The gradients themselves are compared through the buckets:
    two backwards of one step differ (the bilinear upsample backward adds
    with atomics)."""
    import tempfile

    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.parallel.mesh import (
        create_mesh,
        destroy_distributed,
        init_distributed,
    )

    b8 = phase8_batches()[0]
    plain = Trainer(train_config(8), None, device="cuda", model=bf16_model(master))
    with tempfile.TemporaryDirectory() as tmp:
        dev = init_distributed("cuda", f"file://{tmp}/store", 0, 1, 0, 1)
        try:
            backend = torch.distributed.get_backend()
            ddp = Trainer(train_config(8), None, device=str(dev), model=bf16_model(master),
                          mesh=create_mesh({"data": 1}, 1))
            buckets = []

            def hook(state, bucket):
                before = bucket.buffer().clone()

                def done(fut):
                    after = fut.value()
                    after = after[0] if isinstance(after, list) else after
                    buckets.append(bool(torch.equal(before, after)))
                    return after

                return default_hooks.allreduce_hook(None, bucket).then(done)

            ddp.ddp.register_comm_hook(None, hook)
            t0 = time.perf_counter()
            got = step_capture(ddp, b8, torch, raw=True)
            secs = time.perf_counter() - t0
        finally:
            destroy_distributed()
    launches["ddp_1rank"] = got["launches"]
    want = train_launches(512, 8, steps=1)
    ld = plain.forward_loss(*plain.to_device(b8))
    loss = ld["loss"].item()
    del ld
    for n, p in plain.model.named_parameters():
        p.grad = got["grads"][n]
    plain.clip_and_step()
    diff_p = sum(int(not torch.equal(p, got["params"][n]))
                 for n, p in plain.model.named_parameters())
    diff_s = sum(int(not torch.equal(b, got["stats"][n]))
                 for n, b in plain.model.named_buffers() if n in got["stats"])
    log(f"8a DDP 1 rank ({backend}) 512^2 batch 8: step {secs:.3f} s; loss {got['loss']!r} vs "
        f"plain {loss!r}; {len(buckets)} buckets, unchanged by the reduction "
        f"{sum(buckets)}; parameters differing from the plain step on the same gradients "
        f"{diff_p} of {len(got['params'])}, running statistics {diff_s} of "
        f"{len(got['stats'])}; launches {got['launches']} (expected {want})")
    check(backend == "nccl", f"8a: backend {backend}, not NCCL")
    check(got["loss"] == loss, f"8a: DDP loss {got['loss']!r} != plain {loss!r}")
    check(buckets and all(buckets), f"8a: the reduction changed {buckets.count(False)} buckets")
    check(diff_p == 0 and diff_s == 0, f"8a: {diff_p} parameters, {diff_s} statistics differ")
    check(got["launches"] == want, "8a: DDP train launches differ from the routes")
    del plain, ddp, got
    torch.cuda.empty_cache()


def _save_binary(self, filename, seg, edge, original) -> None:
    """PredictionResultManager.save_prediction's binary masks through
    data/png.py (the card's machine has no OpenCV for the heatmaps and
    overlays)."""
    from spegnet_tpu_torch.data.png import write_png

    base = Path(filename).stem
    for root, pred in ((self.seg_dir, seg), (self.edge_dir, edge)):
        write_png(root / "binary" / f"{base}.png", (np.squeeze(pred) * 255).astype(np.uint8))


def rank8(rank: int, world: int, tmp: str) -> None:
    """8b-8d in one of ``world`` spawned ranks sharing the card over gloo;
    rank 0 then leaves the group and runs the one-rank references."""
    import torch

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import PredictionResultManager, Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.parallel import sharding
    from spegnet_tpu_torch.parallel.mesh import (
        create_mesh,
        destroy_distributed,
        init_distributed,
    )
    from spegnet_tpu_torch.utils.run_manager import DirectoryManager

    tmp = Path(tmp)
    PredictionResultManager.save_prediction = _save_binary
    dev = init_distributed("cuda", f"file://{tmp}/store", rank, world, rank, world)
    backend = torch.distributed.get_backend()
    mesh = create_mesh({"data": world}, world)
    master = master_state(torch)
    b8, b7, evb = phase8_batches()
    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
          "image_processing": {"target_size": 512}}
    out, counts = {"backend": backend}, []
    steps = {}
    for tag, batch in (("8", b8), ("7", b7)):
        tr = Trainer(train_config(8), None, device=str(dev), model=bf16_model(master),
                     mesh=mesh)
        t0 = time.perf_counter()
        got = step_capture(tr, batch, torch)
        out[f"step_s_{tag}"] = time.perf_counter() - t0
        counts.append(got.pop("launches"))
        steps[tag] = got if rank == 0 else None
        del tr, got
        torch.cuda.empty_cache()
    ev = Evaluator(None, None, mc, batch_size=8, device=str(dev), model=bf16_model(master),
                   mesh=mesh)
    ev.evaluate(None, "synthetic", loader=[evb])
    out["eval2"] = ev.sample_metrics["synthetic"]
    del ev
    dm = DirectoryManager("predict", base_dir=str(tmp / "pred2"), timestamp="run")
    pred = Predictor(None, mc, dm, batch_size=8, device=str(dev), model=bf16_model(master),
                     mesh=mesh)
    out["pred2"] = pred.predict_directory(str(tmp / "imgs"))
    del pred
    torch.cuda.empty_cache()
    destroy_distributed()
    (tmp / f"launches{rank}.json").write_text(json.dumps(counts))
    if rank:
        return
    # the references: one process, the same global batches (the tail batch
    # padded with its weights, as the global program sees it)
    padded, w = sharding.pad_batch(b7, world)
    padded.sample_w = w
    start = {n: t.cuda() for n, t in master.items()}
    for tag, batch in (("8", b8), ("7", padded)):
        tr = Trainer(train_config(8), None, device=str(dev), model=bf16_model(master))
        ref = step_capture(tr, batch, torch)
        out[f"rows_{tag}"] = (steps[tag]["rows"], ref["rows"])
        out[f"readings_{tag}"] = step_readings(steps[tag], ref, start)
        del tr, ref
        steps[tag] = None
        torch.cuda.empty_cache()
    ev = Evaluator(None, None, mc, batch_size=4, device=str(dev), model=bf16_model(master))
    ev.evaluate(None, "synthetic", loader=[sharding.shard_batch(evb, i, 2) for i in range(2)])
    out["eval1"] = ev.sample_metrics["synthetic"]
    del ev
    dm = DirectoryManager("predict", base_dir=str(tmp / "pred1"), timestamp="run")
    pred = Predictor(None, mc, dm, batch_size=4, device=str(dev), model=bf16_model(master))
    out["pred1"] = pred.predict_directory(str(tmp / "imgs"))
    (tmp / "rank0.json").write_text(json.dumps(out))


def ddp_two_ranks(torch, launches) -> None:
    """8b-8d: two ranks spawned on the card (gloo, a file store), against
    one process on the same global batches, as the module docstring says."""
    import tempfile

    import torch.multiprocessing as mp

    from spegnet_tpu_torch.data.png import write_png

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "imgs").mkdir()
        rng = np.random.default_rng(31)
        for i in range(8):
            write_png(tmp / "imgs" / f"p{i}.png", rng.integers(0, 256, (512, 512, 3),
                                                               dtype=np.uint8))
        t0 = time.perf_counter()
        ctx = mp.start_processes(rank8, args=(2, str(tmp)), nprocs=2, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=10):
                check(time.perf_counter() - t0 < RANK_TIMEOUT,
                      f"8b: the ranks took more than {RANK_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        secs = time.perf_counter() - t0
        out = json.loads((tmp / "rank0.json").read_text())
        per_rank = [json.loads((tmp / f"launches{r}.json").read_text()) for r in range(2)]
        files = {}
        for tag in ("pred1", "pred2"):
            root = tmp / tag / "prediction" / "runs" / "run_run" / "results"
            files[tag] = {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*.png")}
    want = train_launches(512, 4, steps=1)
    launches["ddp_2rank"] = {}
    for r, runs in enumerate(per_rank):
        for c in runs:
            check(c == want, f"8b: rank {r} launches {c} differ from the routes at batch 4 "
                  f"({want})")
            for k, v in c.items():
                launches["ddp_2rank"][k] = launches["ddp_2rank"].get(k, 0) + v
    log(f"8b 2 ranks on one card ({out['backend']}): {secs:.1f} s for 8b-8d with the "
        f"spawn; DDP step {out['step_s_8']:.3f} s (batch 8), {out['step_s_7']:.3f} s (7); "
        f"rows (2 ranks, 1 rank) {out['rows_8']}, {out['rows_7']}; launches per rank and "
        f"step = the routes at batch 4")
    limits = {"loss_rel": DDP_LOSS_REL_LIMIT, "update_rel": DDP_UPDATE_REL_LIMIT,
              "stats_rel": DDP_STATS_REL_LIMIT}
    for tag in ("8", "7"):
        r = out[f"readings_{tag}"]
        log(f"8b batch {tag} vs 1 rank: loss rel {r['loss_rel']:.3e} (limit "
            f"{DDP_LOSS_REL_LIMIT}), clipped gradient cosine {r['grad_cosine']:.6f} (limit "
            f"{DDP_COSINE_LIMIT}), update rel {r['update_rel']:.3e} (limit "
            f"{DDP_UPDATE_REL_LIMIT}), running statistics rel {r['stats_rel']:.3e} (limit "
            f"{DDP_STATS_REL_LIMIT})")
        check(out["backend"] == "gloo", f"8b: backend {out['backend']}")
        check(out[f"rows_{tag}"][0] == out[f"rows_{tag}"][1] == int(tag),
              f"8b: rows {out[f'rows_{tag}']}")
        check(r["grad_cosine"] >= DDP_COSINE_LIMIT
              and all(r[k] <= v for k, v in limits.items()), f"8b batch {tag}: {r}")
    e1, e2 = out["eval1"], out["eval2"]
    check(sorted(e1) == sorted(e2) == [f"synthetic_{i}" for i in range(8)],
          f"8c: samples {sorted(e1)} / {sorted(e2)}")
    worst = max(abs(e2[n][k] - v) for n, m in e1.items() for k, v in m.items())
    log(f"8c evaluate 2 ranks (batch 8) vs 1 (batch 4), 8 samples: max |metric diff| "
        f"{worst:.3e} (limit {METRIC_TOL})")
    check(worst <= METRIC_TOL, f"8c: metrics differ by {worst}")
    same = sorted(k for k in files["pred1"] if files["pred2"].get(k) == files["pred1"][k])
    log(f"8d predict 2 ranks (batch 8) vs 1 (batch 4), 8 images: {len(files['pred2'])} / "
        f"{len(files['pred1'])} PNGs, {len(same)} byte-equal; summary counts "
        f"{out['pred2']['total_predictions']} / {out['pred1']['total_predictions']}")
    check(len(files["pred1"]) == 16 and files["pred1"].keys() == files["pred2"].keys()
          and len(same) == 16, "8d: the PNGs differ")
    check(out["pred2"]["total_predictions"] == out["pred1"]["total_predictions"] == 8,
          "8d: summary counts")


# Phase 8g, sequence parallelism: two ranks on the card split Hiera-L's
# Morton trunk at 1024^2 ({"data": 1, "sp": 2}, model.spatial_axis "sp").
# Its train step against one process on the same batch 2 is held to 2.5x
# the worst reading of the first chip runs, the convention of
# DDP_*_LIMIT (an H100 80GB HBM3 at 700 W): against one process's kernel
# path loss 3.316e-4 relative, cosine 1 - 8.351e-2, update 0.7517,
# running statistics 3.880e-2 -- there the three global blocks run plain
# instead of #1, and the bf16 gradient of these random weights is that
# noisy (the kernel path's cosine to f32 is 0.91 at 512^2); against one
# process on the two ranks' routes (the S = 2 plan run whole, its gathers
# no-ops; PR 18, the head whole there and on the ranks) loss and
# statistics bit-equal, cosine 1 - 9.89e-4, update 0.1874, the worst of
# three runs (1 - 4.37e-4 / 2.92e-4 / 9.89e-4, 0.1415 / 0.1333 / 0.1874:
# the gathers' backward sums dK / dV in another order, the upsample
# backward's atomics vary from run to run, and AdamW's first step
# magnifies the small gradients' noise, as in 8b).
SP_SIZE = 1024
SP_LOSS_REL_LIMIT = 8.3e-4
SP_COSINE_LIMIT = 1 - 2.09e-1
SP_UPDATE_REL_LIMIT = 1.88
SP_STATS_REL_LIMIT = 9.7e-2
SP_EMU_UPDATE_REL_LIMIT = 0.47
# Against one process on the two ranks' routes, whose head runs whole
# (PR 21): the ranks' BatchNorm statistics sum their bands' sums, so they
# are no longer bit-equal (4.195e-6 relative in the first two runs; the
# loss stays bit-equal), and cuDNN picks its algorithms by the band's shape,
# so the eval logits move by a bf16 step (6.836e-3), which the per-sample
# metrics of these flat maps, normalized by their range, turn into
# 7.395e-2 (0 in the full run after: the algorithms cuDNN picks depend on
# what ran before); each limit is 2.5x the first reading (an H100 80GB
# HBM3 at 700 W).  On the CPU the bands' f64 step equals one process's and their
# f32 eval forward is bit-equal (tests/test_torch_spatial.py,
# tests/test_torch_head_bands.py).  The step's cosine to theirs, 1 - 8.18e-4
# / 1.50e-3 / 1.863e-3 in the first three runs with the bands (PR 18's
# three, the head whole: at worst 1 - 9.89e-4), is held at 2.5x the worst.
SP_EMU_STATS_REL_LIMIT = 1.05e-5
SP_EMU_METRIC_LIMIT = 0.185
SP_EMU_COSINE_LIMIT = 1 - 4.66e-3
SP_TIMED = 3   # timed predict calls of batch 2 after the counted one
# Peak memory per rank of 8g before the head ran on row bands (PR 18, the
# head whole on each rank; an H100 80GB HBM3 at 700 W): predict, train; and
# one process's.  8g's train step must now peak below the first.
SP_HEAD_WHOLE_PEAK_GB = (2.394, 9.216)
SP_ONE_PEAK_GB = (6.791, 10.789)
# The head's maps whose rows a rank computes (models/spegnet.py): the fused
# map at H/8 and decoder block i's output at 2^(i + 1) times its rows.
HEAD_MAPS = (("fusion", 1), ("decoder.decoder_blocks.0", 2), ("decoder.decoder_blocks.1", 4),
             ("decoder.decoder_blocks.2", 8))


def head_rows(model) -> dict:
    """{scale over H/8: rows} of the head maps that ``model``'s later
    forwards compute (its band, or the whole map), from forward hooks."""
    rows = {}
    mods = dict(model.named_modules())
    for name, scale in HEAD_MAPS:
        mods[name].register_forward_hook(
            lambda m, a, o, _s=scale: rows.__setitem__(_s, int(o.shape[2])))
    return rows


def band_ranges(rows: dict, index: int, size: int) -> str:
    """A rank's head rows as "H/8 [a, b) of h, ..." (its index in a spatial
    group of ``size``; size 1: the whole maps)."""
    names = {1: "H/8", 2: "H/4", 4: "H/2", 8: "H"}
    return ", ".join(f"{names[int(k)]} [{index * n}, {(index + 1) * n}) of {n * size}"
                     for k, n in sorted(rows.items(), key=lambda kv: int(kv[0])))


def check_bands(rows: dict, size: int, sp: int, tag: str) -> None:
    """``rows`` (head_rows of a rank) are its bands under ``sp`` at an input
    of ``size``^2: models/hiera.head_bands' rows times each map's scale."""
    from spegnet_tpu_torch.models.hiera import head_bands

    n8 = head_bands(size, sp)
    want = {str(s): n8 * s for _, s in HEAD_MAPS}
    check(n8 is not None and {str(k): v for k, v in rows.items()} == want,
          f"{tag}: head rows {rows}, expected the bands {want}")


def _sp_images():
    rng = np.random.default_rng(47)
    return [rng.integers(0, 256, (SP_SIZE, SP_SIZE, 3), dtype=np.uint8) for _ in range(2)]


def _sp_batches():
    """Phase 8g's train batch (2) and eval batch (4 samples), 1024^2."""
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch, synthetic_train_batch

    return (synthetic_train_batch(2, np.random.default_rng(53), SP_SIZE, gt_range=(768, 1024)),
            synthetic_eval_batch(4, np.random.default_rng(59), SP_SIZE, gt_range=(768, 1024),
                                 buckets=(SP_SIZE,)))


def sp_runs(master, mesh, dev, torch, emulate: bool = False) -> dict:
    """8g's predict, evaluate and train step in this process, with the
    spatial axis over ``mesh`` (None: one process without it; with
    ``emulate``, one process on the routes of two ranks: a spatial group of
    one runs the S = 2 plan whole, its gathers no-ops): launches,
    global-block calls, stage outputs, masks, ms/img, peak memory, metrics
    and the eval logits, the step and the parameters' digest after it."""
    import hashlib

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models import hiera
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.ops import fused_block_t as fbt
    from spegnet_tpu_torch.parallel.mesh import TokenShard

    spatial = "sp" if mesh is not None or emulate else None
    trunk_plan = hiera.trunk_plan
    if emulate:
        hiera.trunk_plan = lambda *a, sp=None, **k: trunk_plan(*a, sp=2, **k)
    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
          "image_processing": {"target_size": SP_SIZE}, "spatial_axis": spatial}

    def model():
        m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16",
                                  spatial_axis=spatial))
        m.load_state_dict(master)
        return m

    glob = Counter()
    block_global_sp = fbt.block_global_sp
    fbt.block_global_sp = lambda *a, **k: glob.update(["global_ref"]) or block_global_sp(*a, **k)
    out = {}
    try:
        images = _sp_images()
        pred = Predictor(None, mc, None, batch_size=2, device=str(dev), model=model(), mesh=mesh)
        x = torch.from_numpy(np.stack([pred.processor.process_array(a) for a in images])).to(dev)
        shard = (pred.model.token_shard or TokenShard(None, 0, 1)) if spatial else None
        with torch.inference_mode():
            feats = pred.model.encoder.encoder(x, kernels=True, dtype=torch.bfloat16,
                                               shard=shard)
        out["feats"] = [f.cpu() for f in feats[:3]]
        del feats
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        glob.clear()
        out["predict_head_rows"] = head_rows(pred.model)
        out["seg"], _ = pred.predict_arrays(images)
        torch.cuda.synchronize()
        out["predict_launches"] = {**kernels.launches, **glob}
        out["predict_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        ms = []
        for _ in range(SP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict_arrays(images)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / len(images))
        out["ms_per_img"] = ms
        del pred
        torch.cuda.empty_cache()
        b2, evb = _sp_batches()
        kernels.reset_launches()
        ev = Evaluator(None, None, mc, batch_size=4, device=str(dev), model=model(), mesh=mesh)
        logits = []
        ev.model.register_forward_hook(
            lambda m, i, o: logits.append(o["predictions"][-1].float().cpu()))
        ev.evaluate(None, "synthetic", loader=[evb])
        out["eval_launches"] = dict(kernels.launches)
        out["eval"] = ev.sample_metrics["synthetic"]
        out["eval_logits"] = logits[0]
        del ev
        torch.cuda.empty_cache()
        conf = train_config(2, SP_SIZE)
        conf["model"]["spatial_axis"] = spatial
        tr = Trainer(conf, None, device=str(dev), model=model(), mesh=mesh)
        out["train_head_rows"] = head_rows(tr.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        glob.clear()
        t0 = time.perf_counter()
        step = step_capture(tr, b2, torch)
        out["step_s"] = time.perf_counter() - t0
        out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        step["launches"].update(glob)
        out["step"] = step
        digest = hashlib.sha256()
        for _, p in sorted(tr.model.named_parameters()):
            digest.update(p.detach().cpu().numpy().tobytes())
        out["digest"] = digest.hexdigest()
        out["train_rows"] = step["rows"]
        del tr
        torch.cuda.empty_cache()
    finally:
        fbt.block_global_sp = block_global_sp
        hiera.trunk_plan = trunk_plan
    return out


def rank8g(rank: int, world: int, tmp: str) -> None:
    """8g in one of ``world`` spawned ranks sharing the card over gloo
    ({"data": 1, "sp": world}); rank 0 then leaves the group and runs the
    one-process references."""
    import torch

    from spegnet_tpu_torch.parallel.mesh import (
        create_mesh,
        destroy_distributed,
        init_distributed,
    )

    tmp = Path(tmp)
    dev = init_distributed("cuda", f"file://{tmp}/store", rank, world, rank, world)
    backend = torch.distributed.get_backend()
    mesh = create_mesh({"data": 1, "sp": world}, world, "sp")
    master = master_state(torch)
    sp = sp_runs(master, mesh, dev, torch)
    destroy_distributed()
    keep = ("predict_launches", "eval_launches", "predict_peak_gb", "train_peak_gb",
            "ms_per_img", "digest", "step_s", "predict_head_rows", "train_head_rows")
    (tmp / f"sp{rank}.json").write_text(json.dumps(
        {**{k: sp[k] for k in keep}, "train_launches": sp["step"]["launches"],
         "backend": backend, "sp_index": mesh.sp_index}))
    if rank:
        return
    one = sp_runs(master, None, dev, torch)
    emu = sp_runs(master, None, dev, torch, emulate=True)
    start = {n: t.cuda() for n, t in master.items()}
    feats = [float((a.float() - b.float()).abs().max()) for a, b in zip(sp["feats"], one["feats"])]

    def eval_diff(a, b):
        return max(abs(a["eval"][n][k] - v) for n, m in b["eval"].items() for k, v in m.items())

    def sig(t):
        return torch.sigmoid(t).numpy()

    res = {"feats_max_abs": feats,
           "feats_rel": [e / max(float(b.float().abs().max()), 1e-12)
                         for e, b in zip(feats, one["feats"])],
           "feats_equal": [bool(torch.equal(a, b)) for a, b in zip(sp["feats"], one["feats"])],
           "feats_equal_emu": [bool(torch.equal(a, b)) for a, b in zip(sp["feats"], emu["feats"])],
           "mask_mae": float(np.abs(sp["seg"] - one["seg"]).mean()),
           "mask_max": float(np.abs(sp["seg"] - one["seg"]).max()),
           "mask_max_emu": float(np.abs(sp["seg"] - emu["seg"]).max()),
           "eval_worst": eval_diff(sp, one),
           "eval_worst_emu": eval_diff(sp, emu),
           "eval_mask_mae": float(np.abs(sig(sp["eval_logits"]) - sig(one["eval_logits"])).mean()),
           "eval_logits_max_emu": float((sp["eval_logits"] - emu["eval_logits"]).abs().max()),
           "eval_prob_range": [float(np.ptp(sig(one["eval_logits"][i])))
                               for i in range(len(one["eval_logits"]))],
           "eval_samples": [sorted(sp["eval"]), sorted(one["eval"]), sorted(emu["eval"])],
           "readings": step_readings(sp["step"], one["step"], start),
           "readings_emu": step_readings(sp["step"], emu["step"], start),
           "emu_launches": [emu["predict_launches"], emu["step"]["launches"]],
           "rows": [sp["train_rows"], one["train_rows"]],
           "one": {k: one[k] for k in ("predict_launches", "predict_peak_gb", "train_peak_gb",
                                       "ms_per_img", "step_s", "predict_head_rows")},
           "one_train_launches": one["step"]["launches"]}
    # the accuracy anchor (as 8h's and 8j's): each step's gradient against
    # the plain f32 path's on the same weights and batch
    g32, l32 = f32_grad(master, _sp_batches()[0], SP_SIZE, dev, torch)
    g32 = {n: t.to(dev) for n, t in g32.items()}
    res["cos_f32"] = [grad_cosine(x["step"]["grads"], g32) for x in (sp, one, emu)]
    res["loss_rel_f32"] = [abs(x["step"]["loss"] - l32) / abs(l32) for x in (sp, one, emu)]
    (tmp / "sp_rank0.json").write_text(json.dumps(res))


def sp_two_ranks(torch, launches) -> None:
    """8g: sequence parallelism, two ranks spawned on the card (gloo, a file
    store, {"data": 1, "sp": 2}), against one process, as the module
    docstring says."""
    import tempfile

    import torch.multiprocessing as mp

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ctx = mp.start_processes(rank8g, args=(2, str(tmp)), nprocs=2, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=10):
                check(time.perf_counter() - t0 < RANK_TIMEOUT,
                      f"8g: the ranks took more than {RANK_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        secs = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"sp{r}.json").read_text()) for r in range(2)]
        res = json.loads((tmp / "sp_rank0.json").read_text())
    cfg = HIERA_VARIANTS["large"]
    routes = Counter(trunk_routes(cfg, SP_SIZE // 4, torch.bfloat16, False, sp=2))
    routes.pop("plain", None)
    want = {w: 0 for w in ranks[0]["predict_launches"]}
    want.update(routes)
    want_train = train_launches(SP_SIZE, 2, steps=1, sp=2)
    want_train["global_ref"] = routes["global_ref"]
    launches["sp_2rank"] = {}
    for r, got in enumerate(ranks):
        log(f"8g rank {r} ({got['backend']}) predict 1024^2 batch 2: launches "
            f"{got['predict_launches']} (expected {want})")
        check(got["backend"] == "gloo", f"8g: backend {got['backend']}")
        check(got["predict_launches"] == want, f"8g: rank {r} predict launches differ from the "
              "routes under S = 2")
        check(got["eval_launches"] == {k: v * 2 for k, v in want.items()
                                       if k != "global_ref"},
              f"8g: rank {r} evaluate launches {got['eval_launches']} (warm-up + 1 batch)")
        check(got["train_launches"] == want_train,
              f"8g: rank {r} train launches {got['train_launches']} (expected {want_train})")
        for run in ("predict_launches", "eval_launches", "train_launches"):
            for k, v in got[run].items():
                launches["sp_2rank"][k] = launches["sp_2rank"].get(k, 0) + v
    one = res["one"]
    for r, got in enumerate(ranks):
        log(f"8g rank {r} (sp index {got['sp_index']}) head rows: predict "
            f"{band_ranges(got['predict_head_rows'], got['sp_index'], 2)}; train "
            f"{band_ranges(got['train_head_rows'], got['sp_index'], 2)}; peak memory predict "
            f"{got['predict_peak_gb']:.3f} GB, train {got['train_peak_gb']:.3f} GB (PR 18, the "
            f"head whole: {SP_HEAD_WHOLE_PEAK_GB[0]} / {SP_HEAD_WHOLE_PEAK_GB[1]} GB)")
        check_bands(got["predict_head_rows"], SP_SIZE, 2, f"8g rank {r} predict")
        check_bands(got["train_head_rows"], SP_SIZE, 2, f"8g rank {r} train")
    check(sorted(g["sp_index"] for g in ranks) == [0, 1], "8g: spatial indices")
    log(f"8g one process: head rows {band_ranges(one['predict_head_rows'], 0, 1)}; peak memory "
        f"predict {one['predict_peak_gb']:.3f} GB, train {one['train_peak_gb']:.3f} GB (PR 18: "
        f"{SP_ONE_PEAK_GB[0]} / {SP_ONE_PEAK_GB[1]} GB)")
    log(f"8g 2 ranks on one card: {secs:.1f} s with the spawn and the one-process "
        f"references; one process's predict launches {one['predict_launches']}")
    log(f"8g stage outputs 1-3 (before block 23, the first global block: stages 1 and 2) "
        f"vs one process: max |diff| {res['feats_max_abs']} (relative {res['feats_rel']}), "
        f"bit-equal {res['feats_equal']}")
    log(f"8g predict batch 2: mask MAE vs one process {res['mask_mae']:.4e} (limit "
        f"{MASK_MAE_LIMIT}), max {res['mask_max']:.4e}; ms/img per rank "
        f"{[g['ms_per_img'] for g in ranks]} vs one process {one['ms_per_img']}; peak memory "
        f"per rank {[round(g['predict_peak_gb'], 3) for g in ranks]} GB vs one process "
        f"{one['predict_peak_gb']:.3f} GB")
    log(f"8g one process on the routes of two ranks (the S = 2 plan whole): launches "
        f"{res['emu_launches'][0]}; train {res['emu_launches'][1]}; stage outputs bit-equal "
        f"to the ranks' {res['feats_equal_emu']}, masks max |diff| {res['mask_max_emu']:.3e}")
    log(f"8g evaluate 4 samples: max |metric diff| vs one process on the routes of two ranks "
        f"{res['eval_worst_emu']:.3e} (limit {SP_EMU_METRIC_LIMIT}; logits max |diff| "
        f"{res['eval_logits_max_emu']:.3e}); vs one process's kernel path {res['eval_worst']:.3e} "
        f"(masks MAE {res['eval_mask_mae']:.4e}, limit {MASK_MAE_LIMIT}; each sample's "
        f"probabilities span {res['eval_prob_range']}: the metrics normalize each map by its "
        f"range)")
    r = res["readings"]
    limits = {"loss_rel": SP_LOSS_REL_LIMIT, "update_rel": SP_UPDATE_REL_LIMIT,
              "stats_rel": SP_STATS_REL_LIMIT}
    log(f"8g train step batch 2 vs one process: loss rel {r['loss_rel']:.3e} (limit "
        f"{SP_LOSS_REL_LIMIT}), clipped gradient cosine {r['grad_cosine']:.6f} (limit "
        f"{SP_COSINE_LIMIT}), update rel {r['update_rel']:.3e} (limit {SP_UPDATE_REL_LIMIT}), "
        f"running statistics rel {r['stats_rel']:.3e} (limit {SP_STATS_REL_LIMIT}); step s "
        f"per rank {[round(g['step_s'], 3) for g in ranks]} vs {one['step_s']:.3f}; peak memory "
        f"per rank {[round(g['train_peak_gb'], 3) for g in ranks]} GB vs one process "
        f"{one['train_peak_gb']:.3f} GB; the ranks' parameters bit-equal "
        f"{ranks[0]['digest'] == ranks[1]['digest']}")
    c2, c1, ce = res["cos_f32"]
    log(f"8g train step 1024^2: gradient cosine to the plain f32 path: 2 ranks {c2:.6f}, one "
        f"process {c1:.6f} (the ranks' no lower than one process's less {COSINE_MARGIN}), one "
        f"process on the ranks' routes {ce:.6f}; loss rel to it "
        f"{['%.3e' % v for v in res['loss_rel_f32']]}")
    e = res["readings_emu"]
    log(f"8g train step vs one process on the routes of two ranks (its head whole): loss rel "
        f"{e['loss_rel']:.3e} (equal), clipped gradient cosine "
        f"{e['grad_cosine']:.6f} (limit {SP_EMU_COSINE_LIMIT}), update rel "
        f"{e['update_rel']:.3e} (limit {SP_EMU_UPDATE_REL_LIMIT}), running statistics rel "
        f"{e['stats_rel']:.3e} (limit {SP_EMU_STATS_REL_LIMIT})")
    # every kernel before block 23 works per row or per window, so bit-equal
    # is expected; else the per-kernel limit
    check(all(res["feats_equal"][:2]) or max(res["feats_rel"][:2]) <= kc.REL_LIMIT,
          f"8g: stage outputs before the first global block differ {res['feats_rel']}")
    check(res["mask_mae"] <= MASK_MAE_LIMIT, f"8g: mask MAE {res['mask_mae']:.3e}")
    check(all(ss == [f"synthetic_{i}" for i in range(4)] for ss in res["eval_samples"]),
          f"8g: samples {res['eval_samples']}")
    check(res["eval_mask_mae"] <= MASK_MAE_LIMIT, f"8g: eval mask MAE {res['eval_mask_mae']}")
    check(res["eval_worst_emu"] <= SP_EMU_METRIC_LIMIT,
          f"8g: metrics differ by {res['eval_worst_emu']}")
    check(c2 >= c1 - COSINE_MARGIN, f"8g: gradient cosine to f32 {c2:.4f} < one process's "
          f"{c1:.4f} - {COSINE_MARGIN}")
    check(res["rows"] == [2, 2], f"8g: rows {res['rows']}")
    check(ranks[0]["digest"] == ranks[1]["digest"], "8g: the ranks' parameters differ")
    PEAKS["8g predict 1024^2 batch 2"] = [round(g["predict_peak_gb"], 3) for g in ranks]
    PEAKS["8g train 1024^2 batch 2"] = [round(g["train_peak_gb"], 3) for g in ranks]
    check(r["grad_cosine"] >= SP_COSINE_LIMIT and all(r[k] <= v for k, v in limits.items()),
          f"8g train step vs one process: {r}")
    check(e["loss_rel"] == 0 and e["stats_rel"] <= SP_EMU_STATS_REL_LIMIT
          and e["grad_cosine"] >= SP_EMU_COSINE_LIMIT
          and e["update_rel"] <= SP_EMU_UPDATE_REL_LIMIT,
          f"8g train step vs one process on the routes of two ranks: {e}")
    check(all(g["train_peak_gb"] < SP_HEAD_WHOLE_PEAK_GB[1] for g in ranks),
          f"8g: train peak per rank {[g['train_peak_gb'] for g in ranks]} GB, not below "
          f"{SP_HEAD_WHOLE_PEAK_GB[1]} GB, the head whole (PR 18)")


def remat_phase(master, torch, launches) -> None:
    """8e: training.remat on against off at 384^2 batch 8 (38 decomposed
    blocks on fused_attention_lanes).  Two backwards of one step differ (the
    decoder's bilinear upsample backward adds with atomics), so: the whole
    model's loss equal and its gradient's cosine to the off run's no lower
    than a second off run's less REMAT_COS_SLACK; the trunk's gradients for
    one fixed cotangent on its stage outputs (cuDNN deterministic, as phase
    6(d)) bit-equal wherever two off runs are, the others' cosine no lower
    than the two off runs' less RES_COS_SLACK; then 3 steps per mode on a
    Trainer of its own: peak memory lower with remat, ms/step, launches =
    the routes with the lanes forward twice per step under remat."""
    import dataclasses

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer

    batch = synthetic_train_batch(8, np.random.default_rng(37), 384)
    conf = train_config(8, 384)
    tr = Trainer(conf, None, device="cuda", model=bf16_model(master))
    check(tr.model.config.remat is False, "8e: remat on at batch 8")
    losses, grads = {}, {}
    for run, remat in (("a", False), ("b", False), ("remat", True)):
        tr.model.config = dataclasses.replace(tr.model.config, remat=remat)
        tr.optimizer.zero_grad(set_to_none=True)
        ld = tr.forward_loss(*tr.to_device(batch))
        ld["loss"].backward()
        losses[run] = ld["loss"].item()
        grads[run] = {n: p.grad.detach().float().clone() for n, p in tr.model.named_parameters()}
        del ld
    base, cos = grad_cosine(grads["b"], grads["a"]), grad_cosine(grads["remat"], grads["a"])
    log(f"8e 384^2 batch 8, whole model: losses {losses}; gradient cosine remat to off "
        f"{cos:.6f}, off to off {base:.6f} (slack {REMAT_COS_SLACK})")
    check(losses["remat"] == losses["a"] == losses["b"], f"8e: losses differ {losses}")
    check(cos >= base - REMAT_COS_SLACK, "8e: remat moved the gradient")
    del grads
    tr.model.config = dataclasses.replace(tr.model.config, remat=False)
    trunk = tr.model.encoder.encoder
    names, params = zip(*trunk.named_parameters())
    x = tr._prep(tr.to_device(batch)[0])
    g = torch.Generator().manual_seed(43)
    cot, tg = None, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run, remat in (("a", False), ("b", False), ("remat", True)):
            feats = trunk(x, kernels=True, dtype=torch.bfloat16, remat=remat)
            if cot is None:
                cot = [torch.randn(f.shape, generator=g).to(f.device, f.dtype) for f in feats]
            tg[run] = [t.float() for t in torch.autograd.grad(feats, params, cot)]
            del feats
    finally:
        torch.backends.cudnn.deterministic = deterministic
    varies, differ = [], []
    for name, ga, gb, gr in zip(names, tg["a"], tg["b"], tg["remat"]):
        if torch.equal(ga, gb):
            if not torch.equal(gr, ga):
                differ.append((name, int((gr != ga).sum())))
        else:
            varies.append((name, grad_cosine({"g": gr}, {"g": ga}),
                           grad_cosine({"g": gb}, {"g": ga})))
    log(f"8e trunk gradients (one cotangent, cuDNN deterministic): {len(names) - len(varies)} "
        f"of {len(names)} equal across two off runs, of them {len(differ)} differ under remat "
        f"{differ[:5]}; the others (cosine remat to off, off to off): {varies}")
    check(not differ, f"8e: remat changed trunk gradients: {differ[:5]}")
    check(all(c1 >= c0 - RES_COS_SLACK for _, c1, c0 in varies),
          f"8e: a varying trunk gradient moved under remat: {varies}")
    del tr, tg, x, cot
    torch.cuda.empty_cache()
    peaks = {}
    for remat in (False, True):
        conf["training"]["remat"] = remat
        tr = Trainer(conf, None, device="cuda", model=bf16_model(master))
        check(tr.model.config.remat is remat, "8e: the Trainer did not set remat")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        kernels.reset_launches()
        steps = [tr.train_step(batch) for _ in range(3)]
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = dict(kernels.launches)
        launches[f"train_384_remat_{int(remat)}"] = counts
        want = train_launches(384, 8)
        if remat:
            want["fused_attention_lanes"] *= 2
        ms = [1e3 * (s["timing"]["forward_time"] + s["timing"]["backward_time"])
              for s in steps[1:]]
        log(f"8e 384^2 batch 8 remat {remat}: losses {[s['metrics']['loss'] for s in steps]}, "
            f"ms/step after warm-up {[round(v, 3) for v in ms]}, peak memory "
            f"{peaks[remat]:.2f} GiB ({held:.2f} held before the steps); launches {counts} "
            f"(expected {want})")
        check(counts == want, f"8e remat {remat}: launches differ from the routes")
        del tr, steps
        torch.cuda.empty_cache()
    check(peaks[True] < peaks[False], f"8e: peak with remat {peaks}")


def batch42_phase(master, torch, launches) -> None:
    """8f: the config's batch 42 at 512^2 with remat at its default (on):
    two Trainer steps, ms/step, peak memory <= PEAK_LIMIT_GB, launches = the
    routes."""
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer

    batch = synthetic_train_batch(42, np.random.default_rng(41))
    tr = Trainer(train_config(42), None, device="cuda", model=bf16_model(master))
    check(tr.model.config.remat, "8f: remat is off at batch 42")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    kernels.reset_launches()
    steps = [tr.train_step(batch) for _ in range(2)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches["train_42"] = dict(kernels.launches)
    want = train_launches(512, 42, steps=2)
    ms = [1e3 * (s["timing"]["forward_time"] + s["timing"]["backward_time"]) for s in steps]
    losses = [s["metrics"]["loss"] for s in steps]
    log(f"8f 512^2 batch 42, remat on: losses {losses}, ms/step {[round(v, 3) for v in ms]} "
        f"(the first with its warm-up), peak memory {peak:.2f} GB (limit {PEAK_LIMIT_GB}; "
        f"{held:.2f} GB held before the steps, the smoke's earlier phases' included); "
        f"launches {launches['train_42']} (expected {want})")
    check(all(np.isfinite(losses)), "8f: non-finite loss")
    check(peak <= PEAK_LIMIT_GB, f"8f: peak {peak:.2f} GB")
    check(launches["train_42"] == want, "8f: launches differ from the routes")
    del tr, steps
    torch.cuda.empty_cache()


# Phase 8h, the model (tensor-parallel) axis: two ranks on the card split
# Hiera-L's qkv, attention proj, fc1 and fc2 ({"data": 1, "model": 2}).
# Each train step against one process on the same batch is held to 2.5x the
# worst reading of the first chip run, the convention of DDP_*_LIMIT (an
# H100 80GB HBM3 at 700 W: loss 1.451e-3 relative and statistics 0.1204 at
# 512^2, cosine 1 - 0.2140 and update 0.6826 at 384^2).  Those readings are
# this bf16 gradient's noise (one process's own cosine to f32 is ~0.9): the
# row-parallel sums round once in f32 where one process rounds each GEMM
# to bf16, and the difference grows through the trunk, as 8g's global
# blocks' did.  So each step's gradient is also held against the plain f32
# path's: its cosine no lower than one process's less COSINE_MARGIN.
TP_STEPS = ((384, 4), (512, 2))   # (size, batch) of the two train steps
TP_LOSS_REL_LIMIT = 3.7e-3
TP_COSINE_LIMIT = 1 - 5.36e-1
TP_UPDATE_REL_LIMIT = 1.71
TP_STATS_REL_LIMIT = 0.31
# predicted per-rank saving of peak memory in a train step at M = 2
# (PERF.md): half of the 210.9 M sharded parameters' f32 weight, gradient,
# two AdamW moments and AdamW's temporary, less DDP's gradient buckets
TP_SAVING_PREDICTED_GB = 1.66


def _tp_batches():
    """8h's train batches (384^2 batch 4, 512^2 batch 2 and a second 512^2
    batch 2 for the step after the checkpoint), predict images (2, 512^2)
    and eval batch (4 samples, 512^2)."""
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch, synthetic_train_batch

    rng = np.random.default_rng(61)
    train = {384: synthetic_train_batch(4, rng, 384, gt_range=(288, 512)),
             512: synthetic_train_batch(2, rng, 512)}
    nxt = synthetic_train_batch(2, rng, 512)
    images = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(2)]
    ev = synthetic_eval_batch(4, np.random.default_rng(67), 512, gt_range=(384, 512),
                              buckets=(512,))
    return train, nxt, images, ev


def _full_step(step, trainer):
    """A step_capture result with every shard gathered over the model group
    (a collective), on the host."""
    from spegnet_tpu_torch.parallel.sharding import gather_param

    shard = trainer.mesh.model_shard

    def full(d):
        return {n: (t if shard is None else gather_param(n, t, shard)).cpu()
                for n, t in d.items()}

    return {**step, "grads": full(step["grads"]), "params": full(step["params"]),
            "stats": {n: t.cpu() for n, t in step["stats"].items()}}


def tp_runs(master, mesh, dev, torch, tmp: Path, ckpt=None) -> dict:
    """8h's train steps, predict and evaluate in this process on ``mesh``
    (None: one process): each step with its gradients and parameters
    gathered, launches and peak memory; the masks and launches of predict;
    the per-sample metrics.  Under the model axis the 512^2 step's
    checkpoint is written (rank 0) to tmp/tp_ckpt.pth and a next step taken;
    with ``ckpt`` a one-process Trainer resumed from it takes that step."""
    import gc
    import hashlib

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import ImageProcessor
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.parallel.sharding import shard_dim

    train, nxt, images, evb = _tp_batches()
    out = {}
    # the trunk's stage outputs at 512^2 (inference): the sharded model's
    # against one process's
    m = bf16_model(master).shard_model(None if mesh is None else mesh.model_shard).to(dev)
    x = torch.from_numpy(np.stack([ImageProcessor(512).process_array(a) for a in images]))
    with torch.inference_mode():
        feats = m.eval().encoder.encoder(x.to(dev), kernels=True, dtype=torch.bfloat16)
    out["feats"] = [f.float().cpu() for f in feats]
    del m, feats
    for size, b in TP_STEPS:
        gc.collect()
        torch.cuda.empty_cache()
        tr = Trainer(train_config(b, size), None, device=str(dev), model=bf16_model(master),
                     mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        step = step_capture(tr, train[size], torch)
        out[f"step_s_{size}"] = time.perf_counter() - t0
        out[f"peak_{size}"] = torch.cuda.max_memory_allocated() / 1e9
        out[f"held_{size}"] = held
        out[f"step_{size}"] = _full_step(step, tr)
        del step
        if mesh is not None:
            digest = hashlib.sha256()
            for n, p in sorted(tr.model.named_parameters()):
                if shard_dim(n) is None:
                    digest.update(p.detach().cpu().numpy().tobytes())
            out[f"replicated_digest_{size}"] = digest.hexdigest()
        if size == 512 and mesh is not None:
            state = tr.checkpoint_state(0, {})
            if mesh.rank == 0:
                torch.save(state, tmp / "tp_ckpt.pth")
            del state
            out["next"] = _full_step(step_capture(tr, nxt, torch), tr)
        del tr
        torch.cuda.empty_cache()
        if size == 512 and ckpt is not None:
            gc.collect()
            tr = Trainer(train_config(b, size), None, device=str(dev), model=bf16_model(master))
            tr.load_checkpoint(str(ckpt), resume=True)
            out["ckpt_params"] = {n: p.detach().cpu().clone()
                                  for n, p in tr.model.named_parameters()}
            out["next"] = _full_step(step_capture(tr, nxt, torch), tr)
            del tr
            torch.cuda.empty_cache()
    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
          "image_processing": {"target_size": 512}}
    pred = Predictor(None, mc, None, batch_size=2, device=str(dev), model=bf16_model(master),
                     mesh=mesh)
    pred.predict_arrays(images)    # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    out["seg"], _ = pred.predict_arrays(images)
    torch.cuda.synchronize()
    out["predict_launches"] = dict(kernels.launches)
    del pred
    kernels.reset_launches()
    ev = Evaluator(None, None, mc, batch_size=4, device=str(dev), model=bf16_model(master),
                   mesh=mesh)
    ev.evaluate(None, "synthetic", loader=[evb])
    out["eval_launches"] = dict(kernels.launches)
    out["eval"] = ev.sample_metrics["synthetic"]
    del ev
    gc.collect()
    torch.cuda.empty_cache()
    return out


def f32_grad(master, batch, size: int, dev, torch):
    """The plain f32 path's gradient (TF32 off) of ``batch`` on the weights
    ``master``, on the host, and its loss: the accuracy anchor of 8h's and
    8j's steps."""
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    m = SPEGNet(SPEGNetConfig(variant="large"), kernels=False)
    m.load_state_dict(master)
    tr = Trainer(train_config(batch.images.shape[0], size), None, device=str(dev), model=m)
    ld = tr.forward_loss(*tr.to_device(batch))
    ld["loss"].backward()
    grads = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
    loss = float(ld["loss"])
    del tr, ld, m
    torch.cuda.empty_cache()
    return grads, loss


def rank8h(rank: int, world: int, tmp: str) -> None:
    """8h in one of ``world`` spawned ranks sharing the card over gloo
    ({"data": 1, "model": world}); rank 0 then leaves the group and runs the
    one-process references."""
    import torch

    from spegnet_tpu_torch.parallel.mesh import (
        create_mesh,
        destroy_distributed,
        init_distributed,
    )

    tmp = Path(tmp)
    dev = init_distributed("cuda", f"file://{tmp}/store", rank, world, rank, world)
    backend = torch.distributed.get_backend()
    mesh = create_mesh({"data": 1, "model": world}, world)
    master = master_state(torch)
    tp = tp_runs(master, mesh, dev, torch, tmp)
    destroy_distributed()
    keep = [k for k in tp if k.startswith(("peak_", "held_", "step_s_", "replicated_digest_"))]
    (tmp / f"tp{rank}.json").write_text(json.dumps(
        {**{k: tp[k] for k in keep}, "backend": backend,
         "predict_launches": tp["predict_launches"], "eval_launches": tp["eval_launches"],
         "train_launches": {s: tp[f"step_{s}"]["launches"] for s, _ in TP_STEPS}}))
    if rank:
        return
    one = tp_runs(master, None, dev, torch, tmp, ckpt=tmp / "tp_ckpt.pth")
    start = {n: t for n, t in master.items()}
    res = {f"readings_{s}": step_readings(tp[f"step_{s}"], one[f"step_{s}"], start)
           for s, _ in TP_STEPS}
    res["readings_ckpt"] = step_readings(one["next"], tp["next"], one["ckpt_params"])
    res["rows"] = [[tp[f"step_{s}"]["rows"], one[f"step_{s}"]["rows"]] for s, _ in TP_STEPS]
    res["mask_mae"] = float(np.abs(tp["seg"] - one["seg"]).mean())
    res["eval_worst"] = max(abs(tp["eval"][n][k] - v) for n, m in one["eval"].items()
                            for k, v in m.items())
    res["eval_samples"] = [sorted(tp["eval"]), sorted(one["eval"])]
    res["one"] = {k: one[k] for k in one if k.startswith(("peak_", "held_", "step_s_"))}
    res["feats_rel"] = [float((a - b).abs().max() / b.abs().max()) for a, b in
                        zip(tp["feats"], one["feats"])]
    res["feats_equal"] = [bool(torch.equal(a, b)) for a, b in zip(tp["feats"], one["feats"])]
    train = _tp_batches()[0]
    for size, _ in TP_STEPS:   # last: the f32 Trainer turns TF32 off process-wide
        g32, _ = f32_grad(master, train[size], size, dev, torch)
        res[f"cos_f32_{size}"] = [grad_cosine(tp[f"step_{size}"]["grads"], g32),
                                  grad_cosine(one[f"step_{size}"]["grads"], g32)]
    (tmp / "tp_rank0.json").write_text(json.dumps(res))


def tp_two_ranks(torch, launches) -> None:
    """8h: the model axis, two ranks spawned on the card (gloo, a file
    store, {"data": 1, "model": 2}), against one process, as the module
    docstring says."""
    import tempfile

    import torch.multiprocessing as mp

    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, gathered_blocks, trunk_routes

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ctx = mp.start_processes(rank8h, args=(2, str(tmp)), nprocs=2, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=10):
                check(time.perf_counter() - t0 < RANK_TIMEOUT,
                      f"8h: the ranks took more than {RANK_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        secs = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"tp{r}.json").read_text()) for r in range(2)]
        res = json.loads((tmp / "tp_rank0.json").read_text())
    cfg = HIERA_VARIANTS["large"]
    routes = Counter(trunk_routes(cfg, 512 // 4, torch.bfloat16, False))
    routes.pop("plain", None)
    want = {w: 0 for w in ranks[0]["predict_launches"]}
    want.update(routes)
    want["fused_decoder_block"] = 1
    launches["tp_2rank"] = {}
    log(f"8h 2 ranks on one card ({ranks[0]['backend']}), {{data: 1, model: 2}}: {secs:.1f} s "
        f"with the spawn and the one-process references; blocks whose heads 2 does not "
        f"divide (gathered qkv): {gathered_blocks(cfg, 2)}")
    for r, got in enumerate(ranks):
        check(got["backend"] == "gloo", f"8h: backend {got['backend']}")
        check(got["predict_launches"] == want,
              f"8h: rank {r} predict launches {got['predict_launches']} (expected {want})")
        check(got["eval_launches"] == {k: v * 2 for k, v in want.items()},
              f"8h: rank {r} evaluate launches {got['eval_launches']} (warm-up + 1 batch)")
        for size, b in TP_STEPS:
            exp = train_launches(size, b, steps=1)
            got_t = got["train_launches"][str(size)]
            check(got_t == exp, f"8h: rank {r} train launches at {size}^2 {got_t} (expected "
                                f"{exp})")
        runs = [got["predict_launches"], got["eval_launches"],
                *got["train_launches"].values()]
        for run in runs:
            for k, v in run.items():
                launches["tp_2rank"][k] = launches["tp_2rank"].get(k, 0) + v
    log(f"8h rank 0 launches at 384^2: {ranks[0]['train_launches']['384']}")
    log(f"8h trunk stage outputs 512^2 (inference) vs one process: bit-equal "
        f"{res['feats_equal']}, max |diff| / max {res['feats_rel']}")
    check(res["feats_equal"][0], "8h: stage 1 (two T-blocks on gathered weights) differs from "
          "one process's")
    limits = {"loss_rel": TP_LOSS_REL_LIMIT, "update_rel": TP_UPDATE_REL_LIMIT,
              "stats_rel": TP_STATS_REL_LIMIT}
    one = res["one"]
    for size, b in TP_STEPS:
        r = res[f"readings_{size}"]
        peaks = [g[f"peak_{size}"] for g in ranks]
        PEAKS[f"8h train {size}^2 batch {b}"] = [round(p, 3) for p in peaks]
        log(f"8h train step {size}^2 batch {b} vs one process: loss rel {r['loss_rel']:.3e} "
            f"(limit {TP_LOSS_REL_LIMIT}), clipped gradient cosine {r['grad_cosine']:.6f} "
            f"(limit {TP_COSINE_LIMIT}), update rel {r['update_rel']:.3e} (limit "
            f"{TP_UPDATE_REL_LIMIT}), running statistics rel {r['stats_rel']:.3e} (limit "
            f"{TP_STATS_REL_LIMIT}); replicated parameters bit-equal across the ranks "
            f"{ranks[0][f'replicated_digest_{size}'] == ranks[1][f'replicated_digest_{size}']}")
        log(f"8h memory {size}^2 batch {b}: peak per rank {[round(p, 3) for p in peaks]} GB "
            f"vs one process {one[f'peak_{size}']:.3f} GB: saving "
            f"{[round(one[f'peak_{size}'] - p, 3) for p in peaks]} GB (predicted "
            f"{TP_SAVING_PREDICTED_GB}); held before the step {ranks[0][f'held_{size}']:.3f} "
            f"/ {one[f'held_{size}']:.3f} GB; step s per rank "
            f"{[round(g[f'step_s_{size}'], 3) for g in ranks]} vs {one[f'step_s_{size}']:.3f}")
        tp32, one32 = res[f"cos_f32_{size}"]
        log(f"8h train step {size}^2: gradient cosine to the plain f32 path: 2 ranks "
            f"{tp32:.6f}, one process {one32:.6f} (the ranks' no lower than one process's "
            f"less {COSINE_MARGIN})")
        check(r["grad_cosine"] >= TP_COSINE_LIMIT and all(r[k] <= v for k, v in limits.items()),
              f"8h train step {size}^2 vs one process: {r}")
        check(tp32 >= one32 - COSINE_MARGIN, f"8h: {size}^2 gradient cosine to f32 {tp32:.4f} "
              f"< one process's {one32:.4f} - {COSINE_MARGIN}")
        check(ranks[0][f"replicated_digest_{size}"] == ranks[1][f"replicated_digest_{size}"],
              f"8h: the ranks' replicated parameters differ after the {size}^2 step")
    c = res["readings_ckpt"]
    log(f"8h one process resumed from the TP checkpoint, next step vs the ranks': loss rel "
        f"{c['loss_rel']:.3e}, cosine {c['grad_cosine']:.6f}, update rel "
        f"{c['update_rel']:.3e}, statistics rel {c['stats_rel']:.3e} (the 512^2 limits)")
    check(c["grad_cosine"] >= TP_COSINE_LIMIT and all(c[k] <= v for k, v in limits.items()),
          f"8h: the step after the checkpoint {c}")
    log(f"8h predict 512^2 batch 2: mask MAE vs one process {res['mask_mae']:.4e} (limit "
        f"{MASK_MAE_LIMIT}); evaluate 4 samples: max |metric diff| {res['eval_worst']:.3e} "
        f"(limit {METRIC_TOL})")
    check(res["rows"] == [[4, 4], [2, 2]], f"8h: rows {res['rows']}")
    check(res["mask_mae"] <= MASK_MAE_LIMIT, f"8h: mask MAE {res['mask_mae']:.3e}")
    check(all(s == [f"synthetic_{i}" for i in range(4)] for s in res["eval_samples"]),
          f"8h: samples {res['eval_samples']}")
    check(res["eval_worst"] <= METRIC_TOL, f"8h: metrics differ by {res['eval_worst']}")


# Phase 8j, the spatial axis and the model axis in one mesh: four ranks on
# the card over gloo ({"data": 1, "sp": 2, "model": 2}, model.spatial_axis
# "sp"), Hiera-L bf16 at 512^2, each rank on its token shard of the trunk
# with half of the encoder's qkv, proj, fc1 and fc2.  The train step is held
# against one process's kernel path, and one process resumed from the
# ranks' checkpoint against their next step (SPM_*_LIMIT), and against one
# process on the ranks' routes (the S = 2 plan run whole, unsharded
# weights: SPM_EMU_*_LIMIT), each at 2.5x the worst reading of the first
# chip runs, the convention of DDP_*_LIMIT (an H100 80GB HBM3 at 700 W):
# loss 7.111e-3 relative (the checkpoint's next step), cosine 1 - 0.16943
# (the same), update 0.8109, statistics 0.3146; on the ranks' routes loss
# 5.116e-3, cosine 1 - 0.136644, update 0.8110, statistics 0.2645.  The
# ranks' gradient is closer to the plain f32 path's than one process's
# (cosine 0.858 against 0.813): the row-parallel sums in f32 round less
# than one process's bf16 products, and the readings are that difference
# grown through the trunk, as 8h's.
SPM_MESH = {"data": 1, "sp": 2, "model": 2}
SPM_LOSS_REL_LIMIT = 1.78e-2
SPM_COSINE_LIMIT = 1 - 0.424
SPM_UPDATE_REL_LIMIT = 2.03
SPM_STATS_REL_LIMIT = 0.79
SPM_EMU_LOSS_REL_LIMIT = 1.28e-2
SPM_EMU_COSINE_LIMIT = 1 - 0.342
SPM_EMU_UPDATE_REL_LIMIT = 2.03
SPM_EMU_STATS_REL_LIMIT = 0.67
# 8j's eval metrics against one process on the ranks' routes, whose head
# runs whole (PR 21): 2.5x the first reading, 2.809e-3, as SP_EMU_METRIC_LIMIT
SPM_EMU_METRIC_LIMIT = 7.0e-3
# peak memory per rank of the phases before 8j in this run, printed beside
# its own (filled by 8g and 8h)
PEAKS = {}
# 8j's peaks per rank before the head ran on row bands (PR 20, an H100
# 80GB HBM3 at 700 W): predict, train (the highest rank); one process's
SPM_HEAD_WHOLE_PEAK_GB = (0.947, 3.173)
SPM_ONE_PEAK_GB = (0.794, 5.317)


def _spm_inputs():
    """8j's train batches (512^2 batch 2, and the next step's), predict
    images (2 at 512^2, 2 at 384^2) and eval batch (4 samples, 512^2)."""
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch, synthetic_train_batch

    rng = np.random.default_rng(73)
    train, nxt = (synthetic_train_batch(2, rng, 512) for _ in range(2))
    images = {s: [rng.integers(0, 256, (s, s, 3), dtype=np.uint8) for _ in range(2)]
              for s in (512, 384)}
    ev = synthetic_eval_batch(4, np.random.default_rng(79), 512, gt_range=(384, 512),
                              buckets=(512,))
    return train, nxt, images, ev


def spm_runs(master, mesh, dev, torch, tmp: Path, emulate: bool = False, ckpt=None) -> dict:
    """8j's runs in this process on ``mesh`` (None: one process; with
    ``emulate``, one process on the ranks' routes): predict 512^2 through
    the Predictor (full weights), evaluate 4 samples, a train step (its
    gradients and parameters gathered, launches, peak memory, seconds, the
    digests of the replicated parameters and of this rank's shards), and
    the trainer's eval-mode forward at 384^2 (under the mesh the sharded
    model: lanes attention on H / M heads).  Under the mesh the step's
    checkpoint is written (rank 0) to tmp/spm_ckpt.pth and a next step
    taken; with ``ckpt`` a one-process Trainer resumed from it takes that
    step.  ``emulate`` runs the evaluation and the step only."""
    import gc
    import hashlib

    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import ImageProcessor
    from spegnet_tpu_torch.engine.evaluator import Evaluator
    from spegnet_tpu_torch.engine.predictor import Predictor
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models import hiera
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.ops import fused_block_t as fbt
    from spegnet_tpu_torch.parallel.sharding import shard_dim

    spatial = "sp" if mesh is not None or emulate else None
    train, nxt, images, evb = _spm_inputs()
    mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
          "image_processing": {"target_size": 512}, "spatial_axis": spatial}

    def model():
        m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16",
                                  spatial_axis=spatial))
        m.load_state_dict(master)
        return m

    glob, lanes = Counter(), []
    block_global_sp, trunk_plan, lanes_fn = (fbt.block_global_sp, hiera.trunk_plan,
                                             hiera.fused_attention_lanes)
    fbt.block_global_sp = lambda *a, **k: glob.update(["global_ref"]) or block_global_sp(*a, **k)
    hiera.fused_attention_lanes = lambda qkv, heads, *a, **k: (
        lanes.append((qkv.shape[1], heads)) or lanes_fn(qkv, heads, *a, **k))
    if emulate:
        hiera.trunk_plan = lambda *a, sp=None, **k: trunk_plan(*a, sp=2, **k)

    def counts():
        return {**kernels.launches, "global_ref": glob["global_ref"]}

    def reset():
        kernels.reset_launches()
        glob.clear()

    out = {}
    try:
        if not emulate:
            pred = Predictor(None, mc, None, batch_size=2, device=str(dev), model=model(),
                             mesh=mesh)
            pred.predict_arrays(images[512])   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            out["predict_head_rows"] = head_rows(pred.model)
            out["seg"], _ = pred.predict_arrays(images[512])
            torch.cuda.synchronize()
            out["predict_launches"] = counts()
            out["predict_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            ms = []
            for _ in range(2):
                t0 = time.perf_counter()
                pred.predict_arrays(images[512])
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0) / 2)
            out["ms_per_img"] = ms
            del pred
            gc.collect()
            torch.cuda.empty_cache()
        reset()
        ev = Evaluator(None, None, mc, batch_size=4, device=str(dev), model=model(), mesh=mesh)
        ev.evaluate(None, "synthetic", loader=[evb])
        out["eval_launches"] = counts()
        out["eval"] = ev.sample_metrics["synthetic"]
        del ev
        gc.collect()
        torch.cuda.empty_cache()
        conf = train_config(2, 512)
        conf["model"]["spatial_axis"] = spatial
        tr = Trainer(conf, None, device=str(dev), model=model(), mesh=mesh)
        if not emulate:
            # the trainer's eval-mode forward (its validation) at 384^2, on
            # the weights before the step
            x = torch.from_numpy(np.stack([ImageProcessor(384).process_array(a)
                                           for a in images[384]])).to(dev)
            tr.model.eval()
            torch.cuda.synchronize()
            reset()
            lanes.clear()
            with torch.inference_mode():
                o = tr.model(x)
                out["seg384"] = torch.sigmoid(o["predictions"][-1].float())[..., 0].cpu().numpy()
            out["launches_384"] = counts()
            out["lanes_384"] = list(lanes)
            del o, x
            tr.model.train()
        out["train_head_rows"] = head_rows(tr.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        glob.clear()
        t0 = time.perf_counter()
        step = step_capture(tr, train, torch)
        out["step_s"] = time.perf_counter() - t0
        out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        step["launches"]["global_ref"] = glob["global_ref"]
        out["step"] = _full_step(step, tr)
        del step
        digests = {"replicated": hashlib.sha256(), "shards": hashlib.sha256()}
        for n, p in sorted(tr.model.named_parameters()):
            key = "replicated" if mesh is None or shard_dim(n) is None else "shards"
            digests[key].update(p.detach().cpu().numpy().tobytes())
        out["digests"] = {k: d.hexdigest() for k, d in digests.items()}
        if mesh is not None:
            state = tr.checkpoint_state(0, {})
            if mesh.rank == 0:
                torch.save(state, tmp / "spm_ckpt.pth")
            del state
            out["next"] = _full_step(step_capture(tr, nxt, torch), tr)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        if ckpt is not None:
            tr = Trainer(conf, None, device=str(dev), model=model())
            tr.load_checkpoint(str(ckpt), resume=True)
            out["ckpt_params"] = {n: p.detach().cpu().clone()
                                  for n, p in tr.model.named_parameters()}
            out["next"] = _full_step(step_capture(tr, nxt, torch), tr)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        fbt.block_global_sp, hiera.trunk_plan = block_global_sp, trunk_plan
        hiera.fused_attention_lanes = lanes_fn
    return out


def rank8j(rank: int, world: int, tmp: str) -> None:
    """8j in one of ``world`` spawned ranks sharing the card over gloo
    (SPM_MESH); rank 0 then leaves the group and runs the one-process
    references."""
    import torch

    from spegnet_tpu_torch.parallel.mesh import (
        create_mesh,
        destroy_distributed,
        init_distributed,
    )

    tmp = Path(tmp)
    dev = init_distributed("cuda", f"file://{tmp}/store", rank, world, rank, world)
    backend = torch.distributed.get_backend()
    mesh = create_mesh(SPM_MESH, world, "sp")
    master = master_state(torch)
    runs = spm_runs(master, mesh, dev, torch, tmp)
    destroy_distributed()
    keep = ("predict_launches", "eval_launches", "launches_384", "lanes_384", "predict_peak_gb",
            "train_peak_gb", "ms_per_img", "step_s", "digests", "predict_head_rows",
            "train_head_rows")
    (tmp / f"spm{rank}.json").write_text(json.dumps(
        {**{k: runs[k] for k in keep}, "train_launches": runs["step"]["launches"],
         "rows": runs["step"]["rows"], "backend": backend, "sp_index": mesh.sp_index,
         "model_index": mesh.model_index}))
    if rank:
        return
    one = spm_runs(master, None, dev, torch, tmp, ckpt=tmp / "spm_ckpt.pth")
    emu = spm_runs(master, None, dev, torch, tmp, emulate=True)
    start = {n: t for n, t in master.items()}

    def eval_diff(a, b):
        return max(abs(a["eval"][n][k] - v) for n, m in b["eval"].items() for k, v in m.items())

    res = {"readings": step_readings(runs["step"], one["step"], start),
           "readings_emu": step_readings(runs["step"], emu["step"], start),
           "readings_ckpt": step_readings(one["next"], runs["next"], one["ckpt_params"]),
           "mask_mae": float(np.abs(runs["seg"] - one["seg"]).mean()),
           "mask_mae_384": float(np.abs(runs["seg384"] - one["seg384"]).mean()),
           "eval_worst_emu": eval_diff(runs, emu), "eval_worst": eval_diff(runs, one),
           "eval_samples": [sorted(runs["eval"]), sorted(one["eval"]), sorted(emu["eval"])],
           "rows": [runs["step"]["rows"], one["step"]["rows"]],
           "one_lanes_384": one["lanes_384"],
           "one": {k: one[k] for k in ("predict_peak_gb", "train_peak_gb", "ms_per_img",
                                       "step_s")},
           "emu_train_launches": emu["step"]["launches"]}
    g32, l32 = f32_grad(master, _spm_inputs()[0], 512, dev, torch)   # last: TF32 off
    res["cos_f32"] = [grad_cosine(runs["step"]["grads"], g32),
                      grad_cosine(one["step"]["grads"], g32)]
    res["loss_rel_f32"] = [abs(runs["step"]["loss"] - l32) / abs(l32),
                           abs(one["step"]["loss"] - l32) / abs(l32)]
    (tmp / "spm_rank0.json").write_text(json.dumps(res))


def sp_model_four_ranks(torch, launches) -> None:
    """8j: the spatial and the model axis in one mesh, four ranks spawned on
    the card (gloo, a file store, SPM_MESH), against one process, as the
    module docstring says."""
    import tempfile

    import torch.multiprocessing as mp

    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, block_specs, trunk_routes

    t_phase = time.perf_counter()
    world = int(np.prod(list(SPM_MESH.values())))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ctx = mp.start_processes(rank8j, args=(world, str(tmp)), nprocs=world, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=10):
                check(time.perf_counter() - t_phase < RANK_TIMEOUT,
                      f"8j: the ranks took more than {RANK_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [json.loads((tmp / f"spm{r}.json").read_text()) for r in range(world)]
        res = json.loads((tmp / "spm_rank0.json").read_text())
    cfg = HIERA_VARIANTS["large"]
    zero = {w: 0 for w in ranks[0]["train_launches"]}

    def routes(size):
        c = Counter(trunk_routes(cfg, size // 4, torch.bfloat16, False, sp=2))
        c.pop("plain", None)
        return {**zero, **c}

    want, want384 = routes(512), routes(384)
    want_train = {**zero, **train_launches(512, 2, steps=1, sp=2),
                  "global_ref": want["global_ref"]}
    heads = [sp.heads for sp in block_specs(cfg)]
    launches["sp_model_4rank"] = {}
    for r, got in enumerate(ranks):
        log(f"8j rank {r} (sp {got['sp_index']}, model {got['model_index']}, {got['backend']}) "
            f"launches: predict 512^2 {got['predict_launches']}; train "
            f"{got['train_launches']}; 384^2 {got['launches_384']}")
        check(got["backend"] == "gloo", f"8j: backend {got['backend']}")
        check(got["predict_launches"] == want,
              f"8j: rank {r} predict launches differ from the routes under S = 2 ({want})")
        check(got["eval_launches"] == {k: 2 * v for k, v in want.items()},
              f"8j: rank {r} evaluate launches {got['eval_launches']} (warm-up + 1 batch)")
        check(got["train_launches"] == want_train,
              f"8j: rank {r} train launches (expected {want_train})")
        check(got["launches_384"] == want384,
              f"8j: rank {r} 384^2 launches (expected {want384})")
        check(got["lanes_384"] == [[n, h // 2] for n, h in res["one_lanes_384"]]
              and len(got["lanes_384"]) == want384["fused_attention_lanes"],
              f"8j: rank {r} lanes calls {got['lanes_384'][:4]} are not one process's at H / 2 "
              f"heads {res['one_lanes_384'][:4]}")
        for run in ("predict_launches", "eval_launches", "train_launches", "launches_384"):
            for k, v in got[run].items():
                if k != "global_ref":
                    launches["sp_model_4rank"][k] = launches["sp_model_4rank"].get(k, 0) + v
    log(f"8j 384^2 lanes calls (L, heads) per rank: {ranks[0]['lanes_384'][:3]} ... "
        f"({len(ranks[0]['lanes_384'])} calls; one process's heads "
        f"{sorted(set(h for _, h in res['one_lanes_384']))}, Hiera-L's heads by block "
        f"{sorted(set(heads))})")
    one = res["one"]
    log(f"8j predict 512^2 batch 2: mask MAE vs one process's kernel path "
        f"{res['mask_mae']:.4e} (limit {MASK_MAE_LIMIT}); ms/img per rank "
        f"{[g['ms_per_img'] for g in ranks]} vs one process {one['ms_per_img']}; peak memory "
        f"per rank {[round(g['predict_peak_gb'], 3) for g in ranks]} GB vs one process "
        f"{one['predict_peak_gb']:.3f} GB")
    log(f"8j the trainer's eval-mode forward 384^2 batch 2 (sharded model): mask MAE vs one "
        f"process's kernel path {res['mask_mae_384']:.4e} (limit {MASK_MAE_LIMIT})")
    log(f"8j evaluate 4 samples: max |metric diff| vs one process on the ranks' routes "
        f"{res['eval_worst_emu']:.3e} (limit {SPM_EMU_METRIC_LIMIT}); vs one process's kernel path "
        f"{res['eval_worst']:.3e}")
    steps = (("one process's kernel path", res["readings"],
              (SPM_LOSS_REL_LIMIT, SPM_COSINE_LIMIT, SPM_UPDATE_REL_LIMIT, SPM_STATS_REL_LIMIT)),
             ("one process on the ranks' routes", res["readings_emu"],
              (SPM_EMU_LOSS_REL_LIMIT, SPM_EMU_COSINE_LIMIT, SPM_EMU_UPDATE_REL_LIMIT,
               SPM_EMU_STATS_REL_LIMIT)),
             ("the ranks' next step, one process resumed from their checkpoint",
              res["readings_ckpt"], (SPM_LOSS_REL_LIMIT, SPM_COSINE_LIMIT, SPM_UPDATE_REL_LIMIT,
                                     SPM_STATS_REL_LIMIT)))
    for tag, r, lim in steps:
        log(f"8j train step 512^2 batch 2 vs {tag}: loss rel {r['loss_rel']:.3e} (limit "
            f"{lim[0]}), clipped gradient cosine {r['grad_cosine']:.6f} (limit {lim[1]}), "
            f"update rel {r['update_rel']:.3e} (limit {lim[2]}), running statistics rel "
            f"{r['stats_rel']:.3e} (limit {lim[3]})")
    c4, c1 = res["cos_f32"]
    log(f"8j train step 512^2: gradient cosine to the plain f32 path: 4 ranks {c4:.6f}, one "
        f"process {c1:.6f} (the ranks' no lower than one process's less {COSINE_MARGIN}); "
        f"loss rel to it: 4 ranks {res['loss_rel_f32'][0]:.3e}, one process "
        f"{res['loss_rel_f32'][1]:.3e}")
    reps = {g["digests"]["replicated"] for g in ranks}
    shards = {m: {g["digests"]["shards"] for g in ranks if g["model_index"] == m}
              for m in range(SPM_MESH["model"])}
    log(f"8j parameters after the step: replicated bit-equal on all ranks {len(reps) == 1}; "
        f"each model index's shards bit-equal across its spatial group "
        f"{[len(v) == 1 for v in shards.values()]}")
    for r, got in enumerate(ranks):
        log(f"8j rank {r} (sp {got['sp_index']}, model {got['model_index']}) head rows: predict "
            f"{band_ranges(got['predict_head_rows'], got['sp_index'], 2)}; train "
            f"{band_ranges(got['train_head_rows'], got['sp_index'], 2)}")
        check_bands(got["predict_head_rows"], 512, 2, f"8j rank {r} predict")
        check_bands(got["train_head_rows"], 512, 2, f"8j rank {r} train")
    log(f"8j memory per rank: predict 512^2 {[round(g['predict_peak_gb'], 3) for g in ranks]} "
        f"GB (PR 20, the head whole: {SPM_HEAD_WHOLE_PEAK_GB[0]}), train 512^2 batch 2 "
        f"{[round(g['train_peak_gb'], 3) for g in ranks]} GB (PR 20: "
        f"{SPM_HEAD_WHOLE_PEAK_GB[1]}); one process {one['predict_peak_gb']:.3f} / "
        f"{one['train_peak_gb']:.3f} GB (PR 20: {SPM_ONE_PEAK_GB[0]} / {SPM_ONE_PEAK_GB[1]}); "
        f"earlier phases of this run: {PEAKS}")
    log(f"8j seconds per step: per rank {[round(g['step_s'], 3) for g in ranks]} vs one process "
        f"{one['step_s']:.3f}")
    log(f"8j phase: {time.perf_counter() - t_phase:.1f} s with the spawn and the one-process "
        f"references")
    for tag, r, lim in steps:
        check(r["loss_rel"] <= lim[0] and r["grad_cosine"] >= lim[1]
              and r["update_rel"] <= lim[2] and r["stats_rel"] <= lim[3],
              f"8j train step vs {tag}: {r}")
    check(res["mask_mae"] <= MASK_MAE_LIMIT, f"8j: mask MAE {res['mask_mae']:.3e}")
    check(res["mask_mae_384"] <= MASK_MAE_LIMIT, f"8j: 384^2 mask MAE {res['mask_mae_384']:.3e}")
    check(all(ss == [f"synthetic_{i}" for i in range(4)] for ss in res["eval_samples"]),
          f"8j: samples {res['eval_samples']}")
    check(res["eval_worst_emu"] <= SPM_EMU_METRIC_LIMIT,
          f"8j: metrics differ by {res['eval_worst_emu']}")
    check(res["rows"] == [2, 2] and all(g["rows"] == 2 for g in ranks), f"8j: rows {res['rows']}")
    check(c4 >= c1 - COSINE_MARGIN, f"8j: gradient cosine to f32 {c4:.4f} < one process's "
          f"{c1:.4f} - {COSINE_MARGIN}")
    check(len(reps) == 1 and all(len(v) == 1 for v in shards.values()),
          "8j: the ranks' parameters differ where they must be equal")


def camo_edges_phase(torch) -> None:
    """8i: the CAMO edge processor on the card against its CPU run: 16
    seeded synthetic 512^2 masks (ellipses, some with holes and nested
    parts), edges and validity bit-equal, ms per mask on each."""
    from spegnet_tpu_torch.utils.camo_edges import CAMOEdgeProcessor

    rng = np.random.default_rng(71)
    yy, xx = np.mgrid[:512, :512]
    masks = []
    for i in range(16):
        m = np.zeros((512, 512), bool)
        for _ in range(1 + i % 4):
            cy, cx = rng.integers(-40, 552, 2)
            ry, rx = rng.integers(8, 200, 2)
            e = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            m |= e < 1
            if rng.random() < 0.5:
                m &= ~(e < 0.25)
                m |= e < 0.04
        masks.append((m * 255).astype(np.uint8))
    out = {}
    for dev in ("cuda", "cpu"):
        proc = CAMOEdgeProcessor(edge_width=2, device=dev)
        proc.extract_edges(masks[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = [proc.extract_edges(m) for m in masks]
        out[dev + "_ms"] = 1e3 * (time.perf_counter() - t0) / len(masks)
    proc = CAMOEdgeProcessor(edge_width=2, device="cuda")
    t0 = time.perf_counter()
    for m in masks:
        proc.edge_map(m)
    torch.cuda.synchronize()
    edge_ms = 1e3 * (time.perf_counter() - t0) / len(masks)
    same = [bool(np.array_equal(a[0], b[0]) and a[1] == b[1])
            for a, b in zip(out["cuda"], out["cpu"])]
    valid = [v for _, v in out["cuda"]]
    log(f"8i CAMO edges, 16 masks 512^2, edge_width 2: card vs CPU bit-equal {sum(same)}/16, "
        f"valid {sum(valid)}/16; ms per mask with validation: card {out['cuda_ms']:.2f}, CPU "
        f"{out['cpu_ms']:.2f}; the card's morphology alone {edge_ms:.2f} ms per mask")
    check(all(same), f"8i: the card's edges differ from the CPU's: {same}")


def model_report() -> None:
    """The model report of utils/model_info.py at 512^2."""
    from spegnet_tpu_torch.utils.model_info import model_complexity

    info = model_complexity({"encoder": {"variant": "large"}}, 512)
    log(f"model report 512^2: {info['params']} parameters ({info['params'] / 1e6:.2f} M), "
        f"{info['flops'] / 1e9:.2f} GFLOPs forward at batch 1 (FlopCounterMode on the meta "
        f"device)")
    check(info["params"] > 0 and info["flops"] > 0, f"model report {info}")


if __name__ == "__main__":
    sys.exit(main())
