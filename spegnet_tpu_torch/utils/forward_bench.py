"""Per-forward time of the T-block rows (#1 fused_block_t, #10
fused_block_t_i8) and end-to-end times of Hiera-L SPEGNet at 512^2, batch 8,
on the GPU: the numbers to hold one build of the kernels against another in
one run (run it from each tree, in turns).

    python -m spegnet_tpu_torch.utils.forward_bench [--batch 8] [--steps 5] [--f32]

Prints, per block geometry of kernel_check (stage 1-3 and the global blocks
in bf16, stages 2-3 and the global blocks in int8), the CUDA-events ms of
one wrapper call and its device ms (kernel_check.device_ms, torch.profiler),
and their totals per forward (kernel_check.BLOCK_COUNT) beside the roofline
bound; then the forward ms/img (CUDA events, seeded random weights and
inputs) of the bf16 kernel path, the int8 encoder and the speed mode (both
int8 flags), and the median ms/step of ``--steps`` Trainer steps (forward,
loss, backward, AdamW) after one warm-up step on a synthetic batch.  With
``--f32``, instead: the f32 gen-1 block (#7 at f32) per geometry and per f32
forward, and the f32 forward ms/img (``use_amp: false``, TF32 off) of the
kernel path.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Callable

ROWS = {"fused_block_t": ("stage1", "stage2", "stage3", "global"),
        "fused_block_t_i8": ("stage2_i8", "stage3_i8", "global_i8")}


def blocks(batch: int, log: Callable[[str], None] = print) -> None:
    """Events and device ms of each T-block geometry, and per forward."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc

    dev = torch.device("cuda")
    with torch.inference_mode():
        for row, names in ROWS.items():
            tot = [0.0, 0.0, 0.0]
            for name in names:
                make = kc.i8_case if row.endswith("_i8") else kc.block_case
                case = make(name, batch, torch.Generator().manual_seed(2), dev)
                ev, dv = kc.time_ms(case.kernel), kc.device_ms(case.kernel)
                if row.endswith("_i8"):
                    int8_ops, flops, nbytes = kc.i8_work(name, batch)
                else:
                    int8_ops, (flops, nbytes) = 0.0, kc.work(name, batch)
                b_ms, _ = kc.bound_ms(flops, nbytes, int8_ops)
                n = kc.BLOCK_COUNT[name]
                tot = [tot[0] + ev * n, tot[1] + dv * n, tot[2] + b_ms * n]
                log(f"block {row:16s} {name:9s} batch {batch}: events {ev:.4f} ms, device "
                    f"{dv:.4f} ms, bound {b_ms:.4f} ms (x{n} per forward)")
                del case
            log(f"block {row} per forward: events {tot[0]:.4f} ms, device {tot[1]:.4f} ms, "
                f"bound {tot[2]:.4f} ms")


def end_to_end(batch: int, steps: int, log: Callable[[str], None] = print) -> None:
    """Forward ms/img of the bf16, int8-encoder and speed-mode paths, and the
    median train ms/step, at 512^2."""
    import numpy as np
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    x = torch.randn(batch, 512, 512, 3, generator=torch.Generator().manual_seed(1)).cuda()
    state = None
    for tag, flags in (("bf16", {}), ("int8 encoder", {"int8_encoder": True}),
                       ("speed mode", {"int8_encoder": True, "int8_decoder": True})):
        model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16", **flags))
        if state is None:
            state = init_weights(model, torch.Generator().manual_seed(0)).state_dict()
        model.load_state_dict(state)
        model.eval().to_compute("cuda")
        with torch.inference_mode():
            ms = kc.time_ms(lambda: model(x), iters=10, warmup=3) / batch
        log(f"e2e forward {tag} 512^2 batch {batch}: {ms:.4f} ms/img")
        del model
        torch.cuda.empty_cache()
    conf = {"model": {"encoder": {"variant": "large", "checkpoint_path": None},
                      "compute_dtype": "bfloat16", "image_processing": {"target_size": 512}},
            "training": {"batch_size": batch, "num_epochs": 1, "val_ratio": 0,
                         "gradient_clip": 1}}
    model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
    model.load_state_dict(state)
    trainer = Trainer(conf, None, device="cuda", model=model)
    b = synthetic_train_batch(batch, np.random.default_rng(11))
    trainer.train_step(b)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start.record()
        trainer.train_step(b)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    log(f"e2e train 512^2 batch {batch}: ms/step {[round(t, 3) for t in times]} (median "
        f"{float(np.median(times)):.4f})")


def f32(batch: int, log: Callable[[str], None] = print) -> None:
    """The f32 gen-1 block per geometry (events and device ms, per f32
    forward) and the f32 forward ms/img at 512^2."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tot = [0.0, 0.0]
    with torch.inference_mode():
        for name in kc.F32_BLOCKS:
            case = kc.f32_block_case(name, batch, torch.Generator().manual_seed(2), dev)
            ev, dv = kc.time_ms(case.kernel), kc.device_ms(case.kernel)
            n = kc.COUNT_F32[name]
            tot = [tot[0] + ev * n, tot[1] + dv * n]
            log(f"block fused_block f32 {name:10s} batch {batch}: events {ev:.4f} ms, device "
                f"{dv:.4f} ms (x{n} per forward)")
            del case
        log(f"block fused_block f32 per forward: events {tot[0]:.4f} ms, device {tot[1]:.4f} ms")
        x = torch.randn(batch, 512, 512, 3, generator=torch.Generator().manual_seed(1)).cuda()
        model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="float32"))
        init_weights(model, torch.Generator().manual_seed(0))
        model.eval().to_compute("cuda")
        ms = kc.time_ms(lambda: model(x), iters=3, warmup=1) / batch
        log(f"e2e forward f32 512^2 batch {batch}: {ms:.4f} ms/img")


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--f32", action="store_true", help="the f32 gen-1 block and f32 forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_bench needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}", flush=True)
    if args.f32:
        f32(args.batch, lambda s: print(s, flush=True))
        return
    blocks(args.batch, lambda s: print(s, flush=True))
    end_to_end(args.batch, args.steps, lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
