"""Device time of the weight-gradient GEMM (kernels.gemm_tn,
csrc/hiera_block_bwd.cu) at every weight gradient of one Hiera-L training
step at 512^2 (kernel_check.tn_shapes: the T-block's at stages 1-3 and the
global blocks, the transition fronts', the gen-1 block's at stage 4),
beside torch.mm on the same operands (a yardstick the port never calls).

    python -m spegnet_tpu_torch.utils.gemm_tn_bench [--batch 8]

Prints, per product, the plan (kernels.gemm_tn_plan), the device ms
(kernel_check.device_ms, torch.profiler) of the kernel and of torch.mm, the
kernel's TFLOP/s and GB/s, the roofline bound (kernel_check.tn_work at the
H100's bf16 and memory peaks) and the kernel's max |kernel - mm| / max |mm|
against the f32 torch.mm; then the totals per training step (each
product's count of blocks per step).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

# Blocks of each geometry per Hiera-L training step at 512^2 (the default
# SPEGNET_SAVE_RESIDUALS "0": every T-block through #5).
STEP_COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3,
              "t12": 1, "t23": 1, "t34": 1}


def run(batch: int, log: Callable[[str], None] = print) -> Dict[str, float]:
    """Times every product and returns the per-step totals in ms: kernel,
    torch.mm and bound."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    sms = kernels._sm_count(dev.index or 0)
    tot = {"kernel": 0.0, "mm": 0.0, "bound": 0.0}
    for name, (m, n, k) in kc.tn_shapes(batch).items():
        g = torch.Generator().manual_seed(m + n + k)
        a = torch.randn((m, n), generator=g).to(dev, torch.bfloat16)
        b = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
        got, _ = kernels.gemm_tn(a, b)
        want = torch.mm(a.float().t(), b.float())
        rel = float((got - want).abs().max() / want.abs().max())
        k_ms = kc.device_ms(lambda: kernels.gemm_tn(a, b), iters=10)
        m_ms = kc.device_ms(lambda: torch.mm(a.t(), b), iters=10)
        flops, nbytes = kc.tn_work(m, n, k)
        b_ms, by = kc.bound_ms(flops, nbytes)
        count = STEP_COUNT[name.split("_")[0]]
        tot["kernel"] += k_ms * count
        tot["mm"] += m_ms * count
        tot["bound"] += b_ms * count
        log(f"gemm_tn {name:11s} M {m} N {n} K {k} {kernels.gemm_tn_plan(m, n, k, sms)}: "
            f"kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
            f"{nbytes / k_ms / 1e6:.1f} GB/s), torch.mm {m_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}), rel {rel:.2e} (x{count} per step)")
        del a, b, got, want
    log(f"gemm_tn per training step at batch {batch}: kernel {tot['kernel']:.4f} ms, "
        f"torch.mm {tot['mm']:.4f} ms, bound {tot['bound']:.4f} ms")
    return tot


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_tn_bench needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}", flush=True)
    with torch.inference_mode():
        run(args.batch, lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
