"""Device time of the bf16 attention kernel (csrc/attention_lanes.cu) at
Hiera-L's attention geometries, with one and with two 64-row m-tiles per
consumer warpgroup, beside SDPA on the same q / k / v.

    python -m spegnet_tpu_torch.utils.attention_bench [--batch 8]

Prints, per window length L (kernel_check.ATTN: windows per image, heads,
head dim), the device ms (kernel_check.device_ms, torch.profiler) of each
m-tile count, the count kernels.attention_plan picks, SDPA's device ms, and
the kernel's max |kernel - plain| / max |plain|.  Needs a CUDA device.
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench needs a CUDA device")
    dev = torch.device("cuda")
    sms = kernels._sm_count(torch.cuda.current_device())
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs, batch {args.batch}")
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


if __name__ == "__main__":
    main()
