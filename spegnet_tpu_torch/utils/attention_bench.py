"""Device time of the attention kernels at Hiera-L's attention geometries,
beside SDPA on the same q / k / v.

    python -m spegnet_tpu_torch.utils.attention_bench [--batch 8] [--f32]

bf16 (csrc/attention_lanes.cu): per window length L (kernel_check.ATTN:
windows per image, heads, head dim), the device ms (kernel_check.device_ms,
torch.profiler) with one and with two 64-row m-tiles per consumer
warpgroup, the count kernels.attention_plan picks, SDPA's device ms, and
the kernel's max |kernel - plain| / max |plain|.  ``--f32`` (TF32 off;
csrc/attention_f32.cu): per f32 lanes length and per window of the f32
gen-1 chain (kernel_check.F32_BLOCKS: L 16 and 64), the device ms of
attention_tf32_kernel (kernels.attention_f32_plan) and of SDPA in f32, with
the kernel's error against the plain f32 version.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools


def main(argv=None) -> None:
    import torch
    import torch.nn.functional as F

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.ops import pallas_attention as pa

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench needs a CUDA device")
    dev = torch.device("cuda")
    sms = kernels._sm_count(torch.cuda.current_device())
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs, batch {args.batch}")
    if args.f32:
        with torch.inference_mode():
            f32_rows(args.batch, dev)
        return
    plan = kernels.attention_plan
    with torch.inference_mode():
        for l, (per, heads, d) in sorted(kc.ATTN.items()):
            p = args.batch * per
            qkv = torch.randn((p, l, 3 * heads * d), generator=torch.Generator().manual_seed(l)
                              ).to(dev, torch.bfloat16)
            q, k, v = pa.split_qkv(qkv, heads)
            want = pa.lanes_plain(qkv, heads, d ** -0.5).float()
            cells = [f"plan mt {plan(p, heads, l, kernels.attention_head_dim(d, torch.bfloat16), sms).mt}"]
            for mt in (1, 2):
                try:
                    kernels.attention_plan = functools.partial(plan, mt=mt)
                    got = kernels.attention(q, k, v, d ** -0.5).reshape(p, l, -1).float()
                    rel = float((got - want).abs().max() / want.abs().max())
                    ms = kc.device_ms(lambda: kernels.attention(q, k, v, d ** -0.5), iters=20)
                    cells.append(f"mt {mt} {ms:.4f} ms (rel {rel:.2e})")
                except ValueError as e:   # m-tile count the plan refuses here
                    cells.append(f"mt {mt} -- ({e})")
                finally:
                    kernels.attention_plan = plan
            q4 = [t.transpose(1, 2) for t in (q, k, v)]
            sdpa = kc.device_ms(lambda: F.scaled_dot_product_attention(*q4), iters=20)
            cells.append(f"sdpa {sdpa:.4f} ms")
            print(f"L {l} ({p} x {heads} heads, D {d}): " + ", ".join(cells), flush=True)


def f32_rows(batch: int, dev) -> None:
    """The ``--f32`` table (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.ops import pallas_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geoms = {f"lanes{l}": (kc.ATTN[l][0], kc.ATTN[l][1], kc.ATTN[l][2], l)
             for l in sorted({l for _, l in kc.F32_ATTN_CASES.values()})}
    geoms.update({f"{name} window": (n // l, heads, c // heads, l)
                  for name, (c, heads, l, n) in kc.F32_BLOCKS.items()})
    for name, (per, heads, d, l) in geoms.items():
        p = batch * per
        qkv = torch.randn((p, l, 3 * heads * d), generator=torch.Generator().manual_seed(l)
                          ).to(dev)
        q, k, v = pa.split_qkv(qkv, heads)
        want = pa.lanes_plain(qkv, heads, d ** -0.5)
        got = kernels.attention(q, k, v, d ** -0.5).reshape(p, l, -1)
        rel = float((got - want).abs().max() / want.abs().max())
        ms = kc.device_ms(lambda: kernels.attention(q, k, v, d ** -0.5), iters=10)
        cells = [f"kernel {ms:.4f} ms (rel {rel:.2e}, "
                 f"{kernels.attention_f32_plan(p, heads, l, d, kernels._sm_count(dev.index or 0))})"]
        q4 = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa = kc.device_ms(lambda: F.scaled_dot_product_attention(*q4), iters=10)
        cells.append(f"sdpa f32 {sdpa:.4f} ms")
        print(f"f32 {name} L {l} ({p} x {heads} heads, D {d}): " + ", ".join(cells),
              flush=True)


if __name__ == "__main__":
    main()
