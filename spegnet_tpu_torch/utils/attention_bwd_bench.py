"""Device time of the attention backward (kernels.attention_bwd,
csrc/attention_window_bwd.cu) at every geometry a Hiera-L training step
gives it, beside SDPA's backward on the same windows and the roofline bound;
with ``--against``, another tree's launcher in turns in the same process.

    python -m spegnet_tpu_torch.utils.attention_bwd_bench [--batch 8] [--against build/parent] [--train]

Per geometry of kernel_check.ATTN_BWD that a 512^2 or 384^2 step gives it
(the T-block stages and global blocks, stage 4's gen-1 block, the fronts
with their pooled queries) and the 1024^2 global block (batch 2): the
device ms of one call (kernel_check.device_ms, torch.profiler) and of each
kernel it launches, the host µs one call takes to enqueue (host clock over
back-to-back calls, before the device catches up; the least and the median
of ``--rounds`` runs of 50 calls, the two trees alternating), SDPA's
backward (torch.autograd.grad of F.scaled_dot_product_attention) on the
same q / k / v, the bound (kernel_check.attn_bwd_work), and the totals per
512^2 step.  The other tree (for example the parent commit unpacked with
``git archive``) has its ``spegnet_tpu_torch/kernels.py`` loaded as a
module of its own (utils/window_ab.py), which builds its own library.

``--train`` adds, with each tree's launcher swapped into ``kernels`` in
turn: the device ms per 512^2 step of the T-block backward chains (#5:
ops/fused_block_t.block_cuda_bwd at stages 1-3 and the global blocks), the
gen-1 block's bf16 backward at stage 4 (#7) and the fronts' (#4:
qpool_front_cuda_bwd), and the bf16 Trainer's ms/step at 512^2 and 384^2
(same weights and batch, alternating).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import statistics
from pathlib import Path

# name -> calls per 512^2 training step (the 384^2 ones per 384^2 step)
COUNT = {"stage1": 2, "stage2": 5, "stage3": 32, "global": 3, "stage4": 3, "t12": 1, "t23": 1,
         "t34": 1, "global_1024": 0}
COUNT_384 = {"stage1_384": 2, "stage2_384": 5, "t12_384": 1}


def kernel_ms(fn, iters: int = 20):
    """{kernel name: device ms per call} of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+_kernel)", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def sdpa_bwd(case):
    """SDPA's backward on the windows of ``case``: a zero-argument call."""
    import torch
    import torch.nn.functional as F

    rows, hd = case.y.shape[0], case.heads * case.d
    t = case.y[:, :3 * hd].reshape(rows // case.lk, case.lk, 3, case.heads, case.d)
    q = (t[:, :, 0] if case.q is None
         else case.q.reshape(rows // case.lk, case.lq, case.heads, case.d))
    q, k, v = (x.transpose(1, 2).contiguous().requires_grad_()
               for x in (q, t[:, :, 1], t[:, :, 2]))
    out = F.scaled_dot_product_attention(q, k, v, scale=case.scale)
    g = case.dout.reshape(rows // case.lk, case.lq, case.heads, case.d).transpose(1, 2)
    g = g.contiguous()
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def geometries(args, log) -> None:
    """The per-geometry lines and the totals per 512^2 step."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.utils.window_ab import alternate, host_us

    med = statistics.median
    dev = torch.device("cuda")
    trees = {"new": kernels.attention_bwd}
    if args.old is not None:
        trees["old"] = args.old.attention_bwd
    tot = {k: 0.0 for k in ("new", "old", "sdpa", "bound", "host_new", "host_old")}
    for name in list(COUNT) + list(COUNT_384):
        count = COUNT.get(name, 0)
        batch = 2 if name == "global_1024" else args.batch
        case = kc.attn_bwd_case(name, batch, torch.Generator().manual_seed(2), dev)
        pairs = {v: kc.attn_bwd_launch(case, fn) for v, fn in trees.items()}
        calls = {v: c for v, (c, _) in pairs.items()}
        got = {}
        for v, (c, out) in pairs.items():
            c()
            got[v] = out()[:3]
        if "old" in got:
            rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                      for a, b in zip(got["new"], got["old"]))
            if rel > kc.BWD_REL_LIMIT:
                raise SystemExit(f"{name}: the two launchers disagree ({rel:.3e})")
        dms = {v: kc.device_ms(c, iters=20) for v, c in calls.items()}
        parts = {v: kernel_ms(c) for v, c in calls.items()}
        hosts = alternate({v: (lambda c=c: host_us(c)) for v, c in calls.items()}, args.rounds)
        lib = kc.device_ms(sdpa_bwd(case), iters=10)
        flops, nbytes = kc.attn_bwd_work(name, batch)
        b_ms, by = kc.bound_ms(flops, nbytes)
        plan = kernels.window_bwd_plan(case.o.shape[0], case.heads, case.d, case.lq, case.lk,
                                       kernels._sm_count(dev.index or 0))
        old = (f", old {dms['old']:.4f} ms (" + ", ".join(
            f"{k} {v:.4f}" for k, v in parts["old"].items()) + f"), host old least "
            f"{min(hosts['old']):.2f} median {med(hosts['old']):.2f} us" if "old" in dms else "")
        log(f"attn bwd {name:11s} batch {batch}: new {dms['new']:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in parts["new"].items())
            + f"), host new least {min(hosts['new']):.2f} median {med(hosts['new']):.2f} us"
            f"{old}; sdpa bwd {lib:.4f} ms, bound {b_ms:.4f} ms ({by}), new / bound "
            f"{dms['new'] / b_ms:.2f}, new / sdpa {dms['new'] / lib:.2f} (route {plan.route}, "
            f"x{count} per 512^2 step)")
        for k, v in (("new", dms["new"]), ("old", dms.get("old", 0.0)), ("sdpa", lib),
                     ("bound", b_ms), ("host_new", med(hosts["new"]) / 1e3),
                     ("host_old", med(hosts.get("old", [0.0])) / 1e3)):
            tot[k] += v * count
        del case, calls, got, pairs
        torch.cuda.empty_cache()
    log(f"attn bwd per 512^2 step, batch {args.batch}: new {tot['new']:.4f} ms, old "
        f"{tot['old']:.4f} ms, sdpa bwd {tot['sdpa']:.4f} ms, bound {tot['bound']:.4f} ms; "
        f"host (medians) new {tot['host_new']:.4f} ms, old {tot['host_old']:.4f} ms")


def train(args, log) -> None:
    """#5, #7 and #4 per 512^2 step and the train ms/step, each tree's
    launcher in turn."""
    import numpy as np
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.data.pipeline import synthetic_train_batch
    from spegnet_tpu_torch.engine.trainer import Trainer
    from spegnet_tpu_torch.models.spegnet import SPEGNet, SPEGNetConfig
    from spegnet_tpu_torch.ops import fused_block_t as fbt
    from spegnet_tpu_torch.utils.weights import init_weights
    from spegnet_tpu_torch.utils.window_ab import alternate, report

    trees = {"new": kernels.attention_bwd, "old": args.old.attention_bwd}

    def use(v):
        kernels.attention_bwd = trees[v]

    dev = torch.device("cuda")
    per = {v: {"#5": 0.0, "#7": 0.0, "#4": 0.0} for v in trees}
    for name in ("stage1", "stage2", "stage3", "global", "stage4", "t12", "t23", "t34"):
        g = torch.Generator().manual_seed(4)
        if name in kc.QPOOL:
            cin, cout, heads, l, n = kc.QPOOL[name]
            wts = kc.qpool_weights(cin, cout, g, dev)
            x = torch.randn((args.batch, n, cin), generator=g).to(dev, torch.bfloat16)
            go = torch.randn((args.batch, n // 4, cout), generator=g).to(dev, torch.bfloat16)
            scale = (cout // heads) ** -0.5
            fn = (lambda: fbt.qpool_front_cuda_bwd(x, wts, go, go, heads, l, scale, 1e-6))
            row = "#4"
        else:
            _, c, heads, l, n = kc.BLOCKS[name]
            wts = kc.block_weights(c, heads, g, dev)
            x = torch.randn((args.batch, n, c), generator=g).to(dev, torch.bfloat16)
            dy = torch.randn_like(x)
            scale = (c // heads) ** -0.5
            fn = (lambda: fbt.block_cuda_bwd(x, wts, dy, heads, l, scale, 1e-6))
            row = "#7" if name == "stage4" else "#5"
        ms = {}
        for v in ("old", "new", "new", "old"):
            use(v)
            ms.setdefault(v, []).append(kc.device_ms(fn, iters=5))
        use("new")
        count = kc.BLOCK_COUNT[name]
        log(f"backward {name:7s} {row} batch {args.batch}: device old "
            + " / ".join(f"{x:.4f}" for x in ms["old"]) + " ms, new "
            + " / ".join(f"{x:.4f}" for x in ms["new"]) + f" ms (x{count} per 512^2 step)")
        for v in trees:
            per[v][row] += min(ms[v]) * count
        del x, wts
        torch.cuda.empty_cache()
    for v in trees:
        log(f"backward per 512^2 step ({v}, the lesser of two runs): "
            + ", ".join(f"{k} {x:.4f} ms" for k, x in per[v].items()))

    state = init_weights(SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16")),
                         torch.Generator().manual_seed(0)).state_dict()
    for size in (512, 384):
        conf = {"model": {"encoder": {"variant": "large", "checkpoint_path": None},
                          "compute_dtype": "bfloat16",
                          "image_processing": {"target_size": size}},
                "training": {"batch_size": args.batch, "num_epochs": 1, "val_ratio": 0,
                             "gradient_clip": 1}}
        model = SPEGNet(SPEGNetConfig(variant="large", compute_dtype="bfloat16"))
        model.load_state_dict(state)
        trainer = Trainer(conf, None, device="cuda", model=model)
        batch = synthetic_train_batch(args.batch, np.random.default_rng(11), size)
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

        def step(v):
            use(v)
            torch.cuda.synchronize()
            start.record()
            trainer.train_step(batch)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        for v in trees:
            step(v)
        report(f"train step {size}^2 batch {args.batch}",
               alternate({v: (lambda v=v: step(v)) for v in trees}, args.steps), "ms/step")
        use("new")
        del trainer, model
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--against", type=Path, default=None, help="the other tree")
    ap.add_argument("--rounds", type=int, default=8, help="host-time rounds")
    ap.add_argument("--train", action="store_true",
                    help="the block and front backwards and the train step (needs --against)")
    ap.add_argument("--steps", type=int, default=10, help="train-step rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_bench needs a CUDA device")
    if args.train and args.against is None:
        raise SystemExit("--train holds two trees against each other: give --against")

    def log(s):
        print(s, flush=True)

    log(f"{torch.cuda.get_device_name(0)}, batch {args.batch}")
    args.old = None
    if args.against is not None:
        from spegnet_tpu_torch.utils.window_ab import other_kernels

        args.old = other_kernels(args.against)
    geometries(args, log)
    if args.train:
        train(args, log)


if __name__ == "__main__":
    main()
