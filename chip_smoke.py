#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spegnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without it) and prints the card's name and
   power limit as nvidia-smi reports them.
2. Builds the Hopper kernels from spegnet_tpu_torch/csrc into build/kernels/
   and prints the build seconds.
3. Compares every kernel with its plain PyTorch version in bf16 at every
   main-path geometry of Hiera-L 512^2 inference, batch 2 (stages 1-4, the
   global blocks, the t12/t23/t34 transitions, decoder block 2), against
   kernel_check.REL_LIMIT.
4. Runs the Predictor on 4 seeded synthetic 512^2 u8 images with seeded
   random Hiera-L weights in bf16, with every launch counter zeroed just
   before: each kernel must have launched, outputs must be finite and of the
   expected shapes, and the mask MAE against the plain f32 path
   (kernels=False, TF32 off) on the same weights must be <= 1e-3.
5. Times the kernel path against the plain bf16 path (kernels=False) in
   ms/image at batch 8, and each kernel against its plain version at batch 8,
   with CUDA events.

Any failed check raises.  The last lines are the kernel table (JSON), the
nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MASK_MAE_LIMIT = 1e-3   # BASELINE.md:41 drift budget
KERNELS = {
    # wrapper: (source, TPU kernel it replaces)
    "fused_block_t": ("spegnet_tpu_torch/csrc/hiera_block.cu",
                      "spegnet_tpu/ops/fused_block_t.py:349"),
    "fused_block": ("spegnet_tpu_torch/csrc/hiera_block.cu",
                    "spegnet_tpu/ops/fused_block.py:99"),
    "qpool_front": ("spegnet_tpu_torch/csrc/qpool_front.cu",
                    "spegnet_tpu/ops/fused_block_t.py:634"),
    "fused_decoder_block": ("spegnet_tpu_torch/csrc/decoder_block.cu",
                            "spegnet_tpu/ops/fused_decoder.py:338"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.engine.predictor import Predictor
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
        g = torch.Generator().manual_seed(1)
        case = make(name, 2, g, dev)
        err, rel = kc.compare(case)
        torch.cuda.synchronize()
        max_err[case.wrapper] = max(max_err[case.wrapper], err)
        log(f"check {name:7s} {case.wrapper:20s} max_abs {err:.4e} rel {rel:.4e} "
            f"(limit {kc.REL_LIMIT})")
        check(rel <= kc.REL_LIMIT, f"{name}: kernel disagrees with plain ({rel:.3e})")

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
    launches = dict(kernels.launches)
    log(f"predict: launches {launches}")
    for w, n in launches.items():
        check(n > 0, f"{w} was not launched on the main path")
    check(seg.shape == (4, 512, 512) and edge.shape == (4, 64, 64),
          f"output shapes {seg.shape} {edge.shape}")
    check(bool(np.isfinite(seg).all() and np.isfinite(edge).all()), "non-finite output")
    jax_side = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "spegnet_tpu"))
    check(not jax_side, f"the port imported JAX or the JAX package: {jax_side}")

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

    # -- 5. timings at batch 8 ------------------------------------------------
    x8 = torch.cat([x, x]).to(torch.float32)
    run = {}
    with torch.inference_mode():
        for mode in ("kernel", "plain", "kernel", "plain"):
            model.kernels = mode == "kernel"
            ms = kc.time_ms(lambda: model(x8), iters=5, warmup=2) / 8
            run.setdefault(mode, []).append(ms)
    model.kernels = True
    log(f"e2e ms/img at batch 8: kernel path {run['kernel']}, plain bf16 path {run['plain']}")

    per = {w: [0.0, 0.0] for w in KERNELS}
    with torch.inference_mode():
        for name, make in cases.items():
            case = make(name, 8, torch.Generator().manual_seed(2), dev)
            k_ms, p_ms = kc.time_ms(case.kernel), kc.time_ms(case.plain)
            log(f"time {name:7s} batch 8: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                f"(x{kc.BLOCK_COUNT[name]} per forward)")
            per[case.wrapper][0] += k_ms * kc.BLOCK_COUNT[name]
            per[case.wrapper][1] += p_ms * kc.BLOCK_COUNT[name]

    table = [{"name": w, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[w], "max_abs_err": max_err[w],
              "ms": per[w][0], "plain_ms": per[w][1]}
             for w, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
