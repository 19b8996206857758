"""Device-time breakdown of one SPEGNet forward, or one training step, on the GPU.

    python -m spegnet_tpu_torch.utils.profiling [--batch 8] [--variant large]
        [--plain | --int8] [--train] [--trace trace.json]

Builds seeded random weights, runs two warm-up calls at 512^2 in bf16,
then profiles one call with torch.profiler (CPU + CUDA activities) and
prints the kernels sorted by device time, the device-busy total and the
call's wall time.  The call is an inference forward, or with ``--train``
one Trainer step (forward, loss, backward, clip, AdamW) on a synthetic
batch (data/pipeline.synthetic_train_batch).  ``--plain`` profiles the
kernels=False path instead, ``--int8`` the forward with
``int8_encoder`` (the W8A8 encoder blocks).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m spegnet_tpu_torch.utils.profiling")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--variant", default="large")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--plain", action="store_true", help="profile kernels=False")
    ap.add_argument("--int8", action="store_true", help="forward with int8_encoder")
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--trace", help="write a chrome trace here")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    if args.int8 and (args.train or args.plain):
        raise SystemExit("--int8 profiles the kernel path's forward only")
    cfg = SPEGNetConfig(variant=args.variant, compute_dtype="bfloat16", int8_encoder=args.int8)
    model = init_weights(SPEGNet(cfg, kernels=not args.plain), torch.Generator().manual_seed(0))
    if args.train:
        import numpy as np

        from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
        from spegnet_tpu_torch.engine.trainer import Trainer

        conf = {"model": {"encoder": {"variant": args.variant, "checkpoint_path": None},
                          "compute_dtype": "bfloat16",
                          "image_processing": {"target_size": args.size}},
                "training": {"batch_size": args.batch, "num_epochs": 1, "val_ratio": 0}}
        trainer = Trainer(conf, None, device="cuda", model=model)
        batch = synthetic_train_batch(args.batch, np.random.default_rng(1), args.size)

        def call():
            trainer.train_step(batch)
    else:
        model.eval().to_compute("cuda")
        x = torch.randn(args.batch, args.size, args.size, 3,
                        generator=torch.Generator().manual_seed(1)).cuda()

        def call():
            with torch.inference_mode():
                model(x)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    what = "train step" if args.train else ("int8 forward" if args.int8 else "forward")
    print(f"{what} wall {wall:.3f} ms at batch {args.batch}; device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% of wall)")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[: args.rows]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
