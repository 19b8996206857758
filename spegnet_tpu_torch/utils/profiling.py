"""Device-time breakdown of one SPEGNet forward, or one training step, on the GPU.

    python -m spegnet_tpu_torch.utils.profiling [--batch 8] [--variant large]
        [--size 512] [--plain | --int8] [--int8-decoder] [--f32] [--train [--remat]]
        [--trace trace.json]
    python -m spegnet_tpu_torch.utils.profiling --helpers [--batch 8] [--size 512]

Builds seeded random weights, runs two warm-up calls at ``--size``^2 (512
by default; 384 for a patch grid that is not 2^k) in bf16 (with ``--f32``
in f32, TF32 off, as ``use_amp: false`` runs),
then profiles one call with torch.profiler (CPU + CUDA activities) and
prints the kernels sorted by device time, the device-busy total and the
call's wall time.  The call is an inference forward, or with ``--train``
one Trainer step (forward, loss, backward, clip, AdamW) on a synthetic
batch (data/pipeline.synthetic_train_batch), with ``--remat`` under
``training.remat: true``.  ``--plain`` profiles the
kernels=False path instead, ``--int8`` the forward with
``int8_encoder`` (the W8A8 encoder blocks), ``--int8-decoder`` with
``int8_decoder`` (decoder block 2 in its W8A8 mode; both flags: the speed
mode).  ``--helpers`` reports instead the helper kernels that no PR has
redesigned (LayerNorm forward and backward, the int8 row quant, the 2x2
pool and its scatter, the f32 LayerNorm: :data:`HELPERS`) on a bf16, an
int8 and an f32 forward and a bf16 training step: each one's launches and
device ms in the run, its calls replayed on random operands of the same
shapes, their bytes bound at kernel_check.PEAK_BYTES, and the time of the
one PyTorch call that computes the same function where there is one.
Needs a CUDA device.

:class:`TraceSession` is the trainer's ``training.profile`` /
``profile_dir`` (spegnet_tpu/utils/profiling.py ``TraceSession``): a
torch.profiler trace of a few steps, on the CPU and, where there is one, the
card, written as a Chrome trace.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class TraceSession:
    """Profile ``num_steps`` steps after the first ``skip_steps`` into
    ``trace_dir``/trace.json (trace_rank{rank}.json in a process group);
    :meth:`step` is called once before each step, as the JAX trainer calls
    its own (steps 2-6 by default).  No directory: does nothing."""

    def __init__(self, trace_dir: Optional[str], num_steps: int = 5, skip_steps: int = 1,
                 rank: Optional[int] = None):
        self.trace_dir = trace_dir
        self.num_steps, self.skip_steps = num_steps, skip_steps
        self.name = "trace.json" if rank is None else f"trace_rank{rank}.json"
        self._step = 0
        self._prof = None

    def step(self) -> None:
        if not self.trace_dir:
            return
        self._step += 1
        if self._step == self.skip_steps + 1 and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            Path(self.trace_dir).mkdir(parents=True, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            logger.info(f"profiler trace started -> {self.trace_dir}")
        elif self._prof is not None and self._step > self.skip_steps + self.num_steps:
            self.close()

    def close(self) -> None:
        """Stop a running trace and write it."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = Path(self.trace_dir) / self.name
        prof.export_chrome_trace(str(path))
        logger.info(f"profiler trace written to {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m spegnet_tpu_torch.utils.profiling")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--variant", default="large")
    ap.add_argument("--size", type=int, default=512, help="input side, a multiple of 32")
    ap.add_argument("--plain", action="store_true", help="profile kernels=False")
    ap.add_argument("--int8", action="store_true", help="forward with int8_encoder")
    ap.add_argument("--int8-decoder", action="store_true", help="forward with int8_decoder")
    ap.add_argument("--f32", action="store_true", help="f32 compute (use_amp: false)")
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--remat", action="store_true", help="the training step under remat")
    ap.add_argument("--trace", help="write a chrome trace here")
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--helpers", action="store_true",
                    help="report the helper kernels (module docstring)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    if args.helpers:
        helper_report(args)
        return

    from torch.profiler import ProfilerActivity, profile

    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.device import f32_precision
    from spegnet_tpu_torch.utils.weights import init_weights

    if (args.int8 or args.int8_decoder) and (args.train or args.plain):
        raise SystemExit("--int8 / --int8-decoder profile the kernel path's forward only")
    dtype = "float32" if args.f32 else "bfloat16"
    if dtype == "float32":
        f32_precision(torch.float32)
    cfg = SPEGNetConfig(variant=args.variant, compute_dtype=dtype, int8_encoder=args.int8,
                        int8_decoder=args.int8_decoder)
    model = init_weights(SPEGNet(cfg, kernels=not args.plain), torch.Generator().manual_seed(0))
    if args.train:
        import numpy as np

        from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
        from spegnet_tpu_torch.engine.trainer import Trainer

        conf = {"model": {"encoder": {"variant": args.variant, "checkpoint_path": None},
                          "compute_dtype": dtype,
                          "image_processing": {"target_size": args.size}},
                "training": {"batch_size": args.batch, "num_epochs": 1, "val_ratio": 0}}
        if args.remat:
            conf["training"]["remat"] = True
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
    what = ("f32 " if args.f32 else "") + ("remat " if args.remat else "") + (
        "train step" if args.train else (
        " ".join(["int8"] * args.int8 + ["int8-decoder"] * args.int8_decoder + ["forward"])))
    print(f"{what} wall {wall:.3f} ms at batch {args.batch}; device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% of wall)")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[: args.rows]:
        print(f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


# -- the helper kernels ----------------------------------------------------------

# launcher in kernels.py -> the device kernels it launches (profiler names)
HELPERS = {
    "layernorm": ("layernorm_kernel",),
    # one pass over the rows, then its CTAs' partial rows summed
    "layernorm_bwd": ("layernorm_bwd_kernel", "reduce_rows_kernel"),
    "quant_rows": ("quant_rows_kernel",),
    "pool4_rows": ("pool4_rows_kernel",),
    "pool4_scatter": ("pool4_scatter_kernel",),
    "layernorm_f32": ("layernorm_f32_kernel",),
}


def _signature(name: str, args, kwargs) -> tuple:
    """The shape of one launcher call: what its bytes and its replay need."""
    if name in ("layernorm", "layernorm_f32"):
        return tuple(args[0].shape) + (str(args[0].dtype),)
    if name == "layernorm_bwd":
        dres = kwargs.get("dres", args[4] if len(args) > 4 else None)
        return tuple(args[0].shape) + (dres is not None,)
    if name == "quant_rows":
        return tuple(args[0].shape) + (str(args[0].dtype),)
    if name == "pool4_rows":
        return tuple(args[0].shape) + (args[1], args[2])
    y, g, out = args
    return (tuple(y.t.shape), y.col, tuple(g.shape), tuple(out.t.shape), out.col)


def _bytes(name: str, sig: tuple) -> int:
    """Each input read once, each output written once (weights included)."""
    if name == "layernorm":
        rows, c = sig[:2]
        return 4 * rows * c + 8 * c
    if name == "layernorm_f32":
        rows, c = sig[:2]
        return 8 * rows * c + 8 * c
    if name == "layernorm_bwd":
        rows, c, dres = sig
        return (6 + 2 * dres) * rows * c + 12 * c   # x, dy (, dres) in, dx out; w in, dw, db out
    if name == "quant_rows":
        rows, k, dt = sig
        return rows * k * ((4 if "float32" in dt else 2) + 1) + 4 * rows
    if name == "pool4_rows":
        rows, _, _, ncols = sig
        return rows * ncols * 2 + rows // 4 * ncols * 2
    _, _, (rows_out, ncols), _, _ = sig
    return 2 * rows_out * ncols * 2 + 4 * rows_out * ncols * 2   # y cols, g in; out cols


def _replay(name: str, sig: tuple, library: bool):
    """A call of ``name``'s launcher (or, with ``library``, the one PyTorch
    call computing the same function, or None) on random operands of
    ``sig``."""
    import torch.nn.functional as F

    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    if name in ("layernorm", "layernorm_f32", "layernorm_bwd"):
        rows, c = sig[:2]
        dt = torch.float32 if name == "layernorm_f32" else torch.bfloat16
        x = torch.randn(rows, c, device=dev, dtype=dt)
        w, b = torch.randn(c, device=dev), torch.randn(c, device=dev)
        if library:
            try:   # f32 weights beside bf16 rows, as the kernels take them
                F.layer_norm(x, (c,), w, b, 1e-6)
            except RuntimeError:
                w, b = w.to(dt), b.to(dt)
        if name != "layernorm_bwd":
            if library:
                return lambda: F.layer_norm(x, (c,), w, b, 1e-6)
            return lambda: getattr(kernels, name)(x, w, b, 1e-6)
        dy = torch.randn_like(x)
        dres = torch.randn_like(x) if sig[2] else None
        if library:
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], w, b, 1e-6)
            return lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [c], mean, rstd, w, b, [True, True, True])
        return lambda: kernels.layernorm_bwd(x, w, dy, 1e-6, dres=dres)
    if library:
        return None
    if name == "quant_rows":
        rows, k, dt = sig
        x = torch.randn(rows, k, device=dev,
                        dtype=torch.float32 if "float32" in dt else torch.bfloat16)
        return lambda: kernels.quant_rows(x)
    if name == "pool4_rows":
        rows, ld, col0, ncols = sig
        y = torch.randn(rows, ld, device=dev, dtype=torch.bfloat16)
        return lambda: kernels.pool4_rows(y, col0, ncols)
    yshape, ycol, gshape, oshape, ocol = sig
    y = torch.randn(yshape, device=dev, dtype=torch.bfloat16)
    g = torch.randn(gshape, device=dev, dtype=torch.bfloat16)
    out = torch.zeros(oshape, device=dev, dtype=torch.bfloat16)
    return lambda: kernels.pool4_scatter(kernels.Cols(y, ycol), g, kernels.Cols(out, ocol))


def helper_report(args) -> None:
    """Every helper kernel of HELPERS on the runs that launch it (a bf16,
    int8 and f32 forward and a bf16 training step at ``--batch`` and
    ``--size``): its launches and device ms in the run (torch.profiler), its
    calls replayed on random operands of the same shapes, their bytes bound,
    and the one PyTorch call computing the same function where there is one
    (F.layer_norm with f32 weights, aten.native_layer_norm_backward)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    def sig_calls(run):
        """Run ``run`` once with the launchers recording their calls."""
        calls = {n: Counter() for n in HELPERS}
        saved = {n: getattr(kernels, n) for n in HELPERS}

        def wrap(n):
            def rec(*a, **k):
                calls[n][_signature(n, a, k)] += 1
                return saved[n](*a, **k)
            return rec

        for n in HELPERS:
            setattr(kernels, n, wrap(n))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for n, f in saved.items():
                setattr(kernels, n, f)
        return calls

    for what, run in _runs(args).items():
        for _ in range(2):
            run()
        calls = sig_calls(run)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        for n, kern in HELPERS.items():
            if not calls[n]:
                continue
            hit = [e for e in events if any(k + "(" in e.key or k + "<" in e.key for k in kern)]
            ms = sum(e.self_device_time_total for e in hit) / 1e3
            count = sum(e.count for e in hit)
            nbytes = sum(_bytes(n, s) * c for s, c in calls[n].items())

            def replay(library):
                fns = [(_replay(n, s, library), c) for s, c in calls[n].items()]
                if any(f is None for f, _ in fns):
                    return None
                return kc.device_ms(lambda: [f() for f, c in fns for _ in range(c)], iters=3)

            lib = replay(True)
            print(f"helper {n:14s} {what:14s} calls {sum(calls[n].values()):4d}, kernel "
                  f"launches {count:4d}: device {ms:.4f} ms in the run, replay "
                  f"{replay(False):.4f} ms, bound {nbytes / kc.PEAK_BYTES * 1e3:.4f} ms "
                  f"(bytes, {nbytes / 1e9:.3f} GB), library "
                  + ("-" if lib is None else f"{lib:.4f} ms") + f"; shapes {dict(calls[n])}",
                  flush=True)


def _runs(args):
    """name -> one call: the bf16, int8-encoder and f32 forward of seeded
    random weights and a bf16 Trainer step, at ``args.batch`` and
    ``args.size``."""
    import numpy as np

    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.device import f32_precision
    from spegnet_tpu_torch.utils.weights import init_weights

    def model(**cfg):
        return init_weights(SPEGNet(SPEGNetConfig(variant=args.variant, **cfg)),
                            torch.Generator().manual_seed(0))

    x = torch.randn(args.batch, args.size, args.size, 3,
                    generator=torch.Generator().manual_seed(1)).cuda()
    runs = {}
    for tag, cfg in (("bf16 forward", {"compute_dtype": "bfloat16"}),
                     ("int8 forward", {"compute_dtype": "bfloat16", "int8_encoder": True}),
                     ("f32 forward", {"compute_dtype": "float32"})):
        m = model(**cfg).eval().to_compute("cuda")

        def forward(m=m):
            with torch.inference_mode():
                m(x)

        runs[tag] = forward
    conf = {"model": {"encoder": {"variant": args.variant, "checkpoint_path": None},
                      "compute_dtype": "bfloat16",
                      "image_processing": {"target_size": args.size}},
            "training": {"batch_size": args.batch, "num_epochs": 1, "val_ratio": 0}}
    trainer = Trainer(conf, None, device="cuda", model=model(compute_dtype="bfloat16"))
    batch = synthetic_train_batch(args.batch, np.random.default_rng(1), args.size)
    runs["train step"] = lambda: trainer.train_step(batch)
    f32_precision(torch.float32)
    return runs


if __name__ == "__main__":
    main()
