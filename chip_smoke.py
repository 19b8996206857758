#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spegnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without it) and prints the card's name and
   power limit as nvidia-smi reports them.
2. Builds the Hopper kernels from spegnet_tpu_torch/csrc into build/kernels/
   (one nvcc per source, all started together) and prints the build seconds.
3. Compares every kernel with its plain PyTorch version in bf16 at every
   main-path geometry of Hiera-L 512^2 inference and training, batch 2: the
   forward kernels (stages 1-4, the global blocks, the t12/t23/t34
   transitions, decoder block 2) against kernel_check.REL_LIMIT, and the
   backward kernels (every block and transition geometry plus a t23 case
   with forced pool ties) against bf16 autograd of the plain version, dx and
   every weight gradient, against kernel_check.BWD_REL_LIMIT.
   Then each int8 kernel of the flagged int8 encoder (model.int8_encoder)
   against its plain int8 version at every int8 geometry of Hiera-L 512^2
   (stages 2-4, the global blocks, t23, t34), batch 2: the whole block by
   kernel_check.i8_ok (REL_LIMIT and at most one dequant step; the share of
   elements beyond the JAX package's 5e-4 is printed), and its int8 pieces
   (LayerNorm + quant, row quant, every GEMM with its epilogue) exactly or
   within one code / one bf16 step by kernel_check.i8_parts_ok.
4. Runs the Predictor on 4 seeded synthetic 512^2 u8 images with seeded
   random Hiera-L weights in bf16, with every launch counter zeroed just
   before: each forward kernel must have launched, outputs must be finite
   and of the expected shapes, and the mask MAE against the plain f32 path
   (kernels=False, TF32 off) on the same weights must be <= 1e-3.
   4b. The same with int8_encoder: every launch counter must equal the
   per-forward count of models/hiera.trunk_routes (JAX's gates: 40 int8
   T-blocks, 2 int8 fronts, 3 int8 gen-1 blocks, 2 bf16 blocks, 1 bf16
   front, 1 decoder block), and the int8 mask MAE against the f32 plain
   path must be <= MASK_MAE_I8_LIMIT (also printed against the bf16 kernel
   path).
5. Times the kernel path against the plain bf16 path (kernels=False) and
   the int8 kernel path in ms/image at batch 8, and each kernel -- forward
   and backward, and the int8 ones -- against its plain version at batch 8
   with CUDA events, beside its roofline bound (kernel_check.work /
   i8_work / bound_ms); then each sub-kernel of the stage-1 and global
   geometries against the one PyTorch call that computes the same function
   (F.linear, scaled_dot_product_attention and its backward, F.layer_norm
   and its backward, a transposed matmul), and the int8 GEMM of stage 3's
   fc1 against torch._int_mm, as yardsticks the port never calls.
6. Training, Hiera-L 512^2, bf16 compute, f32 master weights, synthetic
   TrainBatches (u8 images; {0,1} ellipse masks at original sizes 384-640 on
   a 640 canvas; edges their morphological boundary):
   (a) batch 2, same weights and batch: the gradient through the kernel
       path, the plain bf16 path and the plain f32 path (TF32 off); the
       cosine of each bf16 gradient to the f32 one, overall and for the
       encoder group, and the kernel path no worse than the plain bf16 path
       by more than 0.01;
   (b) batch 8: three Trainer steps on the kernel path with every launch
       counter zeroed just before (losses finite, all six forward and
       backward kernels launched, parameters and BN running statistics
       changed), then four more; ms/step of the six steps after the first
       (CUDA events, each and their median) and peak memory, for the kernel
       and the plain bf16 path.
7. Evaluate: the Evaluator in memory on 8 synthetic eval samples (ellipse
   ground truths at original sizes 384-640 on a 640 canvas, their distance
   transforms from scipy) for the bf16 and the int8 config: metrics finite
   and in [0, 1], the card's metrics equal to the port's CPU metrics on the
   same quantized predictions within 1e-5, forward and metrics ms/image.
8. No module of JAX, flax, optax or the JAX package was imported by any of
   the above.

Any failed check raises.  The last lines are the kernel table (JSON), the
nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MASK_MAE_LIMIT = 1e-3   # BASELINE.md:41 drift budget
# int8 encoder mask MAE vs the f32 plain path: the JAX package calls int8
# accuracy a measured quantity; this limit is 2.5x the first value measured
# on an H100 (4.9432e-04, PERF.md), the convention of the backward limit.
MASK_MAE_I8_LIMIT = 1.24e-3
METRIC_TOL = 1e-5
COSINE_MARGIN = 0.01
TIMED_STEPS = 6   # train steps timed after the warm-up step
KERNELS = {
    # wrapper (launch counter): (source, TPU kernel it replaces)
    "fused_block_t": ("spegnet_tpu_torch/csrc/hiera_block.cu",
                      "spegnet_tpu/ops/fused_block_t.py:349"),
    "fused_block": ("spegnet_tpu_torch/csrc/hiera_block.cu",
                    "spegnet_tpu/ops/fused_block.py:99"),
    "qpool_front": ("spegnet_tpu_torch/csrc/qpool_front.cu",
                    "spegnet_tpu/ops/fused_block_t.py:634"),
    "fused_decoder_block": ("spegnet_tpu_torch/csrc/decoder_block.cu",
                            "spegnet_tpu/ops/fused_decoder.py:338"),
    "fused_block_t_bwd": ("spegnet_tpu_torch/csrc/hiera_block_bwd.cu",
                          "spegnet_tpu/ops/fused_block_t.py:1165"),
    "fused_block_bwd": ("spegnet_tpu_torch/csrc/hiera_block_bwd.cu",
                        "spegnet_tpu/ops/fused_block.py:274"),
    "qpool_front_bwd": ("spegnet_tpu_torch/csrc/qpool_front_bwd.cu",
                        "spegnet_tpu/ops/fused_block_t.py:833"),
    "fused_block_t_i8": ("spegnet_tpu_torch/csrc/int8_gemm.cu",
                         "spegnet_tpu/ops/fused_block_t_i8.py:137"),
    "qpool_front_i8": ("spegnet_tpu_torch/csrc/int8_gemm.cu",
                       "spegnet_tpu/ops/fused_block_t_i8.py:294"),
    "fused_block_i8": ("spegnet_tpu_torch/csrc/int8_gemm.cu",
                       "spegnet_tpu/ops/fused_block_i8.py:128"),
}
TRAIN_COUNTERS = ("fused_block_t", "fused_block", "qpool_front", "fused_block_t_bwd",
                  "fused_block_bwd", "qpool_front_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def train_config(batch: int):
    return {"model": {"encoder": {"variant": "large", "checkpoint_path": None},
                      "compute_dtype": "bfloat16", "image_processing": {"target_size": 512}},
            "training": {"batch_size": batch, "num_epochs": 1, "val_ratio": 0,
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
    from spegnet_tpu_torch.models.hiera import HIERA_VARIANTS, trunk_routes
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    log(f"build: {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

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
    kernels.reset_launches()
    seg, edge = predictor.predict_arrays(images)
    torch.cuda.synchronize()
    launches = {"predict": dict(kernels.launches)}
    log(f"predict: launches {launches['predict']}")
    for w in ("fused_block_t", "fused_block", "qpool_front", "fused_decoder_block"):
        check(launches["predict"][w] > 0, f"{w} was not launched on the predict path")
    check(seg.shape == (4, 512, 512) and edge.shape == (4, 64, 64),
          f"output shapes {seg.shape} {edge.shape}")
    check(bool(np.isfinite(seg).all() and np.isfinite(edge).all()), "non-finite output")

    anchor = SPEGNet(SPEGNetConfig(variant="large"), kernels=False)
    anchor.load_state_dict(state)
    anchor.eval().to_compute(dev)
    x = torch.from_numpy(np.stack([predictor.processor.process_array(a)
                                   for a in images])).to(dev)
    with torch.inference_mode():
        out = anchor(x)
        seg32 = torch.sigmoid(out["predictions"][-1].float())[..., 0].cpu().numpy()
        edge32 = torch.sigmoid(out["edge"].float())[..., 0].cpu().numpy()
    mae = float(np.abs(seg - seg32).mean())
    log(f"predict: mask MAE vs f32 plain {mae:.4e} (limit {MASK_MAE_LIMIT}), "
        f"max {np.abs(seg - seg32).max():.4e}; edge MAE {np.abs(edge - edge32).mean():.4e}")
    check(mae <= MASK_MAE_LIMIT, f"mask MAE {mae:.3e} > {MASK_MAE_LIMIT}")
    del anchor, out
    torch.cuda.empty_cache()

    # -- 4b. the Predictor with the int8 encoder -------------------------------
    cfg_i8 = SPEGNetConfig(variant="large", compute_dtype="bfloat16", int8_encoder=True)
    model_i8 = SPEGNet(cfg_i8)
    model_i8.load_state_dict(state)
    pred_i8 = Predictor(None, {**model_config, "int8_encoder": True}, None, batch_size=4,
                        device="cuda", model=model_i8)
    kernels.reset_launches()
    seg_i8, edge_i8 = pred_i8.predict_arrays(images)
    torch.cuda.synchronize()
    launches["predict_int8"] = dict(kernels.launches)
    want = {w: 0 for w in kernels.launches}
    want.update(Counter(trunk_routes(HIERA_VARIANTS["large"], 128, torch.bfloat16, True)))
    want["fused_decoder_block"] = 1
    log(f"predict int8: launches {launches['predict_int8']} (expected {want})")
    check(launches["predict_int8"] == want, "int8 predict launches differ from the routes")
    check(bool(np.isfinite(seg_i8).all() and np.isfinite(edge_i8).all()),
          "non-finite int8 output")
    mae_i8 = float(np.abs(seg_i8 - seg32).mean())
    log(f"predict int8: mask MAE vs f32 plain {mae_i8:.4e} (limit {MASK_MAE_I8_LIMIT}), "
        f"max {np.abs(seg_i8 - seg32).max():.4e}; vs bf16 kernel path "
        f"{np.abs(seg_i8 - seg).mean():.4e}; edge MAE vs f32 plain "
        f"{np.abs(edge_i8 - edge32).mean():.4e}")
    check(mae_i8 <= MASK_MAE_I8_LIMIT, f"int8 mask MAE {mae_i8:.3e} > {MASK_MAE_I8_LIMIT}")

    # -- 5. timings at batch 8 ------------------------------------------------
    x8 = torch.cat([x, x]).to(torch.float32)
    run = {}
    with torch.inference_mode():
        for mode in ("kernel", "int8", "plain", "plain", "int8", "kernel"):
            m = pred_i8.model if mode == "int8" else model
            model.kernels = mode != "plain"
            ms = kc.time_ms(lambda: m(x8), iters=5, warmup=2) / 8
            run.setdefault(mode, []).append(ms)
    model.kernels = True
    log(f"e2e ms/img at batch 8: kernel path {run['kernel']}, int8 kernel path {run['int8']}, "
        f"plain bf16 path {run['plain']}")
    del model, predictor, model_i8, pred_i8
    torch.cuda.empty_cache()

    per = {w: {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0} for w in KERNELS}

    def account(wrapper, name, k_ms, p_ms, backward=False):
        n = kc.BLOCK_COUNT[name.replace("_ties", "")]
        if name in kc.I8:
            int8_ops, flops, nbytes = kc.i8_work(name, 8)
        else:
            int8_ops = 0.0
            flops, nbytes = kc.work(name.replace("_ties", ""), 8, backward)
        b_ms, by = kc.bound_ms(flops, nbytes, int8_ops)
        log(f"time {name:8s} {wrapper:20s} batch 8: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by}) (x{n} per step)")
        p = per[wrapper]
        p["ms"] += k_ms * n
        p["plain_ms"] += p_ms * n
        p["ops_ms" if by == "operations" else "bytes_ms"] += b_ms * n

    with torch.inference_mode():
        for name, make in cases.items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            account(case.wrapper, name, kc.time_ms(case.kernel), kc.time_ms(case.plain))
    for name in kc.GRAD_CASES:
        if name.endswith("_ties"):
            continue
        case = kc.grad_case(name, 8, torch.Generator().manual_seed(2), dev)
        account(case.wrapper, name, kc.time_ms(case.kernel_bwd), kc.time_ms(case.plain_bwd),
                backward=True)
        del case
        torch.cuda.empty_cache()
    with torch.inference_mode():
        for name, make in kc.i8_cases().items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            account(case.wrapper, name, kc.time_ms(case.kernel), kc.time_ms(case.plain))
            del case
    torch.cuda.empty_cache()
    yardsticks(kc, kernels, F, torch, dev)

    # -- 6. training ------------------------------------------------------------
    master = init_weights(SPEGNet(SPEGNetConfig(variant="large")),
                          torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(11)
    b2 = synthetic_train_batch(2, rng)
    log(f"train: batch 2 canvas {b2.masks.shape[1:]}, mask sizes {b2.mask_hw.tolist()}")

    def make_trainer(batch, kernels_on, dtype="bfloat16"):
        conf = train_config(batch)
        conf["model"]["compute_dtype"] = dtype
        m = SPEGNet(SPEGNetConfig(variant="large", compute_dtype=dtype), kernels=kernels_on)
        m.load_state_dict(master)
        return Trainer(conf, None, device="cuda", model=m)

    grads, losses = {}, {}
    for path, (kern, dtype) in {"kernel": (True, "bfloat16"), "plain": (False, "bfloat16"),
                                "f32": (False, "float32")}.items():
        tr = make_trainer(2, kern, dtype)
        ld = tr.forward_loss(*tr.to_device(b2))
        ld["loss"].backward()
        losses[path] = ld["loss"].item()
        grads[path] = {n: p.grad.detach().float() for n, p in tr.model.named_parameters()}
        check(all(torch.isfinite(g).all().item() for g in grads[path].values()),
              f"{path} gradient not finite")
        del tr, ld
        torch.cuda.empty_cache()

    def cosine(a, b, prefix=""):
        dot = na = nb = 0.0
        for n in a:
            if n.startswith(prefix):
                dot += float((a[n].double() * b[n].double()).sum())
                na += float((a[n].double() ** 2).sum())
                nb += float((b[n].double() ** 2).sum())
        return dot / max(np.sqrt(na * nb), 1e-300)

    cos = {(p, grp): cosine(grads[p], grads["f32"], pre) for p in ("kernel", "plain")
           for grp, pre in (("all", ""), ("encoder", "encoder."))}
    log(f"train grad (batch 2): loss kernel {losses['kernel']:.6f} plain bf16 "
        f"{losses['plain']:.6f} f32 {losses['f32']:.6f}")
    for grp in ("all", "encoder"):
        log(f"train grad cosine to f32 ({grp}): kernel {cos[('kernel', grp)]:.6f}, "
            f"plain bf16 {cos[('plain', grp)]:.6f}")
        check(cos[("kernel", grp)] >= cos[("plain", grp)] - COSINE_MARGIN,
              f"kernel-path gradient ({grp}) cosine {cos[('kernel', grp)]:.4f} < plain "
              f"{cos[('plain', grp)]:.4f} - {COSINE_MARGIN}")
    del grads
    torch.cuda.empty_cache()

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
            log(f"train: launches {launches['train']}")
            for w in TRAIN_COUNTERS:
                check(launches["train"][w] > 0, f"{w} was not launched on the train path")
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

    # -- 7. evaluate -------------------------------------------------------------
    evaluate_phase(state, torch, dev)

    jax_side = sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "spegnet_tpu"))
    check(not jax_side, f"the port imported JAX-package modules: {jax_side[:5]}")

    table = []
    for w, (src, rep) in KERNELS.items():
        p = per[w]
        bound = p["ops_ms"] + p["bytes_ms"]
        table.append({"name": w, "route": "cuda", "source": src, "replaces": rep,
                      "launches": sum(run_l.get(w, 0) for run_l in launches.values()),
                      "max_abs_err": max_err[w], "ms": p["ms"], "plain_ms": p["plain_ms"],
                      "bound_ms": bound,
                      "bound_by": "operations" if p["ops_ms"] >= p["bytes_ms"] else "bytes",
                      "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def evaluate_phase(state, torch, dev) -> None:
    """The Evaluator in memory on 8 synthetic samples, bf16 and int8 configs;
    the card's metrics against the CPU's on the same quantized predictions."""
    from spegnet_tpu_torch.data.pipeline import synthetic_eval_batch
    from spegnet_tpu_torch.engine.evaluator import METRIC_KEYS, Evaluator
    from spegnet_tpu_torch.losses import resize_logits_to_canvas
    from spegnet_tpu_torch.metrics.torch_metrics import (
        compute_batch_metrics,
        quantize_predictions,
    )
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig

    batch = synthetic_eval_batch(8, np.random.default_rng(13))
    log(f"evaluate: 8 samples, canvas {batch.masks.shape[1:]}, sizes {batch.mask_hw.tolist()}")
    for int8 in (False, True):
        mc = {"encoder": {"variant": "large"}, "compute_dtype": "bfloat16",
              "int8_encoder": int8, "image_processing": {"target_size": 512}}
        model = SPEGNet(SPEGNetConfig.from_dict(mc))
        model.load_state_dict(state)
        ev = Evaluator(None, None, mc, batch_size=8, device="cuda", model=model)
        means = ev.evaluate(None, "synthetic", loader=[batch, batch])
        t = ev.summaries["synthetic"]["timing"]
        tag = "int8" if int8 else "bf16"
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
    """Each sub-kernel of the stage-1 and global block geometries at batch 8
    beside the one PyTorch call that computes the same function (timed
    here, never called by the port)."""
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
            "weight grad": (lambda: kernels.gemm_tn(qkv, x),
                            lambda: torch.mm(qkv.t(), x)),
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


if __name__ == "__main__":
    sys.exit(main())
