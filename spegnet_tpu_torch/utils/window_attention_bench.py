"""Device time of the window attention (kernels.window_attention and
kernels.qpool_attention) at every geometry a Hiera-L 512^2 forward gives it,
beside SDPA on the same windows and the roofline bound: the numbers to hold
one build of the kernel against another in one run (run it from each tree,
in turns).

    python -m spegnet_tpu_torch.utils.window_attention_bench [--batch 8] [--no-choices]

Per geometry of kernel_check.WINDOW that a 512^2 forward gives it (the
T-block stages and global blocks, stage 4's gen-1 block, the fronts with
their pooled queries) and the 1024^2 global block: the device ms of one
call without and with the log-sum-exp (kernel_check.device_ms,
torch.profiler), its CUDA-events ms, the host µs one call takes to enqueue
(host clock over back-to-back calls, before any synchronise, the least of 5
runs) and events less device, SDPA's device ms on the same windows, the
bound (q, k, v read once, o written once, 4 Lk D FLOPs per query row and
head), and the totals per 512^2 forward; with ``choices``, the device ms
at each m-tile count kernels.window_plan can take there, each plan passed
to the launcher.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Callable

# name -> calls per 512^2 forward
COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3, "t12": 1,
         "t23": 1, "t34": 1, "global_1024": 0}


def enqueue_us(fn, calls: int = 100, reps: int = 5) -> float:
    """Host µs per call: the least over ``reps`` runs of ``calls``
    back-to-back calls, each timed before the device catches up (the launch
    cost the host pays; the least, since the card's host is shared)."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def run(batch: int, log: Callable[[str], None] = print, choices: bool = True) -> None:
    """The lines described above; ``choices``: time the plan's choices too."""
    import torch
    import torch.nn.functional as F

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    sms = kernels._sm_count(dev.index or 0)
    tot = dict.fromkeys(("kernel", "lse", "sdpa", "bound", "host"), 0.0)
    with torch.inference_mode():
        for name, c in COUNT.items():
            pooled, b = kc.WINDOW[name][3], batch if c else 2
            qkv, (heads, d, lk, scale) = kc.window_inputs(name, b, torch.Generator().manual_seed(2),
                                                          dev)
            rows = qkv.shape[0]
            lq = lk // 4 if pooled else lk
            q_rows = rows // 4 if pooled else rows
            fn = kernels.qpool_attention if pooled else kernels.window_attention
            call = functools.partial(fn, qkv, heads, d, lk, scale)
            t = qkv[:, :3 * heads * d].reshape(rows // lk, lk, 3, heads, d)
            q = (t[:, :, 0].reshape(rows // lk, lq, 4, heads, d).amax(2) if pooled
                 else t[:, :, 0])
            q, k, v = (x.transpose(1, 2).contiguous() for x in (q, t[:, :, 1], t[:, :, 2]))
            dev_ms = kc.device_ms(call, iters=20)
            lse_ms = kc.device_ms(lambda: call(with_lse=True), iters=20)
            ev_ms = kc.time_ms(call, iters=50)
            host = enqueue_us(call)
            sdpa_ms = kc.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                   iters=20)
            flops = 4.0 * q_rows * heads * lk * d
            nbytes = 2.0 * heads * d * (3 * rows + q_rows)
            b_ms, by = kc.bound_ms(flops, nbytes)
            plan = kernels.window_plan(q_rows, heads, d, lq, lk, sms, pool=pooled)
            cells = f" (plan: {plan})"
            for mt in (1, 2) if choices else ():   # the m-tile counts the plan can take
                try:
                    p = kernels.window_plan(q_rows, heads, d, lq, lk, sms, mt, pooled)
                except ValueError:
                    continue
                cells += f", mt {mt} {kc.device_ms(lambda: call(plan=p), iters=20):.4f} ms"
            for key, val in (("kernel", dev_ms), ("lse", lse_ms), ("sdpa", sdpa_ms),
                             ("bound", b_ms), ("host", host / 1e3)):
                tot[key] += val * c
            log(f"window {name:11s} batch {b}: device {dev_ms:.4f} ms (with lse "
                f"{lse_ms:.4f}), events {ev_ms:.4f} ms, host {host:.1f} us/call (events - "
                f"device {max(ev_ms - dev_ms, 0.0) * 1e3:.1f} us), sdpa device {sdpa_ms:.4f} "
                f"ms, bound {b_ms:.4f} ms ({by}), device / bound {dev_ms / b_ms:.2f}"
                f"{cells} (x{c} per forward)")
            del qkv, q, k, v
    log(f"window per 512^2 forward, batch {batch}: device {tot['kernel']:.4f} ms (with lse "
        f"{tot['lse']:.4f}), sdpa {tot['sdpa']:.4f} ms, bound {tot['bound']:.4f} ms, host "
        f"{tot['host']:.4f} ms")


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-choices", action="store_true",
                    help="time only the plan's pick at each geometry")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("window_attention_bench needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}", flush=True)
    run(args.batch, lambda s: print(s, flush=True), choices=not args.no_choices)


if __name__ == "__main__":
    main()
