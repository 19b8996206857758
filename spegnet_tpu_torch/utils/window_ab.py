"""Hold this tree's window attention launchers (kernels.window_attention and
kernels.qpool_attention) against another tree's in one process, where the
card's host is the same for both.

    python -m spegnet_tpu_torch.utils.window_ab --against build/parent

The other tree (for example the parent commit unpacked with ``git
archive``) has its own ``spegnet_tpu_torch/kernels.py`` loaded under
another module name: it builds its library from its own sources and its
launchers run as they are there.  Then, alternating the two in every
round:

* per kernel_check.WINDOW geometry of a 512^2 forward (batch ``--batch``),
  the host µs per launcher call (host clock over back-to-back calls, before
  the device catches up; the least and the median of ``--rounds`` runs of
  50 calls), the device ms of each (kernel_check.device_ms), and the host
  time per forward;
* Hiera-L SPEGNet's forward ms/img at 512^2 in bf16, with the int8 encoder
  and in the speed mode (both int8 flags), and the train ms/step, with each
  tree's pair of launchers swapped into this tree's ``kernels`` (same
  weights, input and batch): medians, ranges and the pairs this tree's
  launchers win.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import time
from pathlib import Path

# name -> calls per 512^2 forward
COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3, "t12": 1,
         "t23": 1, "t34": 1}


def other_kernels(tree: Path):
    """``tree``'s spegnet_tpu_torch/kernels.py as a module of its own."""
    path = tree.resolve() / "spegnet_tpu_torch" / "kernels.py"
    spec = importlib.util.spec_from_file_location("window_ab_other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load()
    return mod


def host_us(fn, calls: int = 50) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def alternate(fns, rounds: int):
    """{name: [value per round]} of each zero-argument measurement in
    ``fns``, their order swapped every round."""
    names, out = list(fns), {n: [] for n in fns}
    for r in range(rounds):
        for n in (names if r % 2 else names[::-1]):
            out[n].append(fns[n]())
    return out


def report(what, res, unit):
    med = statistics.median
    wins = sum(n < o for n, o in zip(res["new"], res["old"]))
    print(f"{what}: old median {med(res['old']):.4f} [{min(res['old']):.4f}, "
          f"{max(res['old']):.4f}], new median {med(res['new']):.4f} [{min(res['new']):.4f}, "
          f"{max(res['new']):.4f}] {unit}; new faster in {wins} of {len(res['new'])} pairs",
          flush=True)


def launchers(args) -> None:
    """The per-geometry lines and the host time per forward."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    med = statistics.median
    dev = torch.device("cuda")
    tot = {"old": 0.0, "new": 0.0}
    with torch.inference_mode():
        for name, count in COUNT.items():
            qkv, call_args = kc.window_inputs(name, args.batch,
                                              torch.Generator().manual_seed(2), dev)
            kind = "qpool_attention" if kc.WINDOW[name][3] else "window_attention"
            calls = {v: (lambda f=getattr(m, kind): f(qkv, *call_args))
                     for v, m in (("old", args.old), ("new", kernels))}
            a, b = (calls[v]().float() for v in ("old", "new"))
            if float((a - b).abs().max() / a.abs().max()) > kc.REL_LIMIT:
                raise SystemExit(f"{name}: the two launchers disagree")
            res = alternate({v: (lambda c=c: host_us(c)) for v, c in calls.items()},
                            args.rounds)
            dms = {v: kc.device_ms(c, iters=20) for v, c in calls.items()}
            for v in tot:
                tot[v] += med(res[v]) * count
            print(f"{name:7s}: host old least {min(res['old']):.2f} median "
                  f"{med(res['old']):.2f}, new least {min(res['new']):.2f} median "
                  f"{med(res['new']):.2f} us/call; device old {dms['old']:.4f}, new "
                  f"{dms['new']:.4f} ms (x{count} per forward)", flush=True)
            del qkv, a, b
    print(f"host per 512^2 forward (medians x calls): old {tot['old'] / 1e3:.4f} ms, new "
          f"{tot['new'] / 1e3:.4f} ms", flush=True)


def end_to_end(args) -> None:
    """Forward ms/img (bf16, int8 encoder, speed mode) and train ms/step."""
    import numpy as np
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.utils.weights import init_weights

    pairs = {"old": (args.old.window_attention, args.old.qpool_attention),
             "new": (kernels.window_attention, kernels.qpool_attention)}

    def use(v):
        kernels.window_attention, kernels.qpool_attention = pairs[v]

    state = init_weights(SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16")),
                         torch.Generator().manual_seed(0)).state_dict()
    x = torch.randn(args.batch, 512, 512, 3, generator=torch.Generator().manual_seed(1)).cuda()
    for tag, flags in (("bf16", {}), ("int8 encoder", {"int8_encoder": True}),
                       ("speed mode", {"int8_encoder": True, "int8_decoder": True})):
        model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16", **flags))
        model.load_state_dict(state)
        model.eval().to_compute("cuda")

        def forward(v):
            use(v)
            return kc.time_ms(lambda: model(x), iters=3, warmup=1) / args.batch

        with torch.inference_mode():
            report(f"forward {tag} 512^2", alternate(
                {v: (lambda v=v: forward(v)) for v in pairs}, args.pairs), "ms/img")
        del model
        torch.cuda.empty_cache()
    conf = {"model": {"encoder": {"variant": "large", "checkpoint_path": None},
                      "compute_dtype": "bfloat16", "image_processing": {"target_size": 512}},
            "training": {"batch_size": args.batch, "num_epochs": 1, "val_ratio": 0,
                         "gradient_clip": 1}}
    model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
    model.load_state_dict(state)
    trainer = Trainer(conf, None, device="cuda", model=model)
    batch = synthetic_train_batch(args.batch, np.random.default_rng(11))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def step(v):
        use(v)
        torch.cuda.synchronize()
        start.record()
        trainer.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for v in pairs:
        step(v)
    report("train step 512^2", alternate({v: (lambda v=v: step(v)) for v in pairs},
                                         args.steps), "ms/step")
    use("new")


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True, help="the other tree")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=12, help="host-time rounds")
    ap.add_argument("--pairs", type=int, default=20, help="forward rounds per mode")
    ap.add_argument("--steps", type=int, default=12, help="train-step rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_ab needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}", flush=True)
    args.old = other_kernels(args.against)
    launchers(args)
    end_to_end(args)


if __name__ == "__main__":
    main()
