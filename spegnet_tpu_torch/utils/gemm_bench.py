"""Device time of the forward GEMMs (kernels.gemm in bf16, kernels.gemm_i8 in
int8) at every forward product of one Hiera-L forward at 512^2
(kernel_check.gemm_shapes: the T-block's four projections at stages 1-3 and
the global blocks, the gen-1 block's at stage 4, the transition fronts'
stacked products), beside torch.mm (bf16) or torch._int_mm (int8, int32
out) on the same operands: yardsticks the port never calls.

    python -m spegnet_tpu_torch.utils.gemm_bench [--batch 8]
        [--digests OUT.json] [--against REF.json] [--tree TREE]
        [--handoff] [--f32] [--lnq8] [--codes OUT.pt] [--codes-against REF.pt]

Prints, per product and epilogue (bias, GELU, residual as the block runs
it), the launch plan (kernels.gemm_plan), the device ms
(kernel_check.device_ms, torch.profiler) of the kernel and the yardstick,
the kernel's TFLOP/s or TOPS and GB/s, the roofline bound
(kernel_check.gemm_work at the H100's bf16 / int8 and memory peaks) and the
kernel's error (bf16: max |kernel - mm| / max |mm| against the f32
torch.mm; int8: elements that differ from the exact integer sum's dequant,
GELU products excepted); then the totals per forward: #1's products (the
T-block at stages 1-3), #10's (stages 2-3 in int8), and every product of
the bf16 and the int8-encoder forwards.  ``--digests`` writes, and
``--against`` compares with a file written before (by another build of the
kernels), the SHA-256 of every output of kernels.gemm / gemm_gelu_pre /
gemm_gelu_grad / gemm_i8 on seeded inputs at every forward product and at
the dX products of the block backward (:func:`digests`), which shows
whether two builds give the same bits.  ``--tree TREE`` loads
another tree's ``spegnet_tpu_torch/kernels.py`` (for example the parent
commit unpacked with ``git archive``; it builds its own library) and times
its launcher beside this tree's on the same operands, in turns, at every
product.

``--handoff`` times the hand-off GEMM (csrc/gemm_handoff.cuh) at every
product it takes (kernel_check.GEMM_HO) and, with ``--tree``, the other
tree's launcher on the same operands, in turns, beside torch.mm, the plain
version and the bound, with the totals per 512^2 forward
(:func:`run_handoff`).

``--f32`` times instead the f32 GEMM (kernels.gemm_f32, the 3xTF32 form)
at every product of the f32 gen-1 blocks (kernel_check.gemm_f32_shapes:
512^2 and 384^2) against F.linear in f32 with TF32 off (cuBLAS's f32 GEMM,
a yardstick the port never calls) and the bound at kernel_check.PEAK_F32,
with the per-forward totals.  ``--lnq8`` times the LayerNorm + quant row pass
(kernels.layernorm_q8) at each kernel_check.LNQ8 geometry against its plain
version and its bytes bound, with the totals per int8 forward.
``--codes`` writes (torch.save) and ``--codes-against`` compares with a file
written before by another build, its codes and scales on seeded rows at
each LNQ8 geometry: the share of codes that differ, and by how much.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

# The rows whose per-forward totals are printed: the geometries of each.
TOTALS = {"#1 fused_block_t": ("bf16", ("stage1", "stage2", "stage3")),
          "#10 fused_block_t_i8": ("int8", ("stage2", "stage3")),
          "bf16 forward": ("bf16", ("stage1", "stage2", "stage3", "stage4", "t12", "t23", "t34")),
          "int8-encoder forward": ("mixed", ())}


def alternate(old, new, rounds: int = 2):
    """Device ms of two calls measured in turns (old, new, new, old, ...),
    each the mean of its rounds."""
    from spegnet_tpu_torch import kernel_check as kc

    t = {0: [], 1: []}
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            t[i].append(kc.device_ms((old, new)[i], iters=10))
    return sum(t[0]) / rounds, sum(t[1]) / rounds


def _bf16_call(m, n, k, gelu, res, g, dev, kernels=None):
    import torch

    if kernels is None:
        from spegnet_tpu_torch import kernels

    a = torch.randn((m, k), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((n, k), generator=g) * k ** -0.5).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn((n,), generator=g)).to(dev, torch.bfloat16)
    r = torch.randn((m, n), generator=g).to(dev, torch.bfloat16) if res else None

    def kern():
        return kernels.gemm(a, w, bias, residual=r, gelu=gelu)

    got = kern().float()
    want = torch.mm(a.float(), w.float().t()) + bias.float()
    if gelu:
        want = torch.nn.functional.gelu(want, approximate="tanh")
    if r is not None:
        want = want + r.float()
    err = f"rel {float((got - want).abs().max() / want.abs().max()):.2e}"
    return kern, lambda: torch.mm(a, w.t()), err


def _i8_call(m, n, k, gelu, res, g, dev, kernels=None):
    import torch

    from spegnet_tpu_torch.ops.fused_block_t_i8 import qdot

    if kernels is None:
        from spegnet_tpu_torch import kernels

    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(dev)
    sa = (torch.rand(m, generator=g) * 0.02).to(dev)
    sw = (torch.rand(n, generator=g) * 2e-3).to(dev)
    bias = (0.1 * torch.randn((n,), generator=g)).to(dev)
    r = torch.randn((m, n), generator=g).to(dev, torch.bfloat16) if res else None

    def kern():
        return kernels.gemm_i8(a, sa, w, sw, bias, residual=r, gelu=gelu)

    got = kern()
    want = qdot(a, sa[:, None], w, sw, bias)
    if gelu:
        want = torch.nn.functional.gelu(want, approximate="tanh")
    want = want.to(torch.bfloat16)
    if r is not None:
        want = r + want
    err = f"differ {int((got != want).sum())}{' (GELU)' if gelu else ''}"
    return kern, lambda: torch._int_mm(a, w.t()), err


def run(batch: int, log: Callable[[str], None] = print,
        other=None) -> Dict[str, Dict[str, float]]:
    """Times every product and returns the per-forward totals in ms of each
    row of :data:`TOTALS`: kernel, yardstick and bound (and, given ``other``,
    another tree's kernels module, its launcher's time on the same operands,
    in turns with this tree's)."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    sms = kernels._sm_count(dev.index or 0)
    plan = getattr(kernels, "gemm_plan", None)
    times = {}   # (dtype, geometry) -> [kernel, yardstick, bound] ms summed over products
    for name, (m, n, k, gelu, res) in kc.gemm_shapes(batch).items():
        geo = name.split("_")[0]
        for dt in ("bf16", "int8"):
            if dt == "int8" and geo not in kc.GEMM_I8_GEOMS:
                continue
            g = torch.Generator().manual_seed(m + n + k)
            make = _i8_call if dt == "int8" else _bf16_call
            kern, lib, err = make(m, n, k, gelu, res, g, dev)
            old = ""
            if other is not None:
                okern = make(m, n, k, gelu, res, torch.Generator().manual_seed(m + n + k), dev,
                             other)[0]
                o_ms, k_ms = alternate(okern, kern)
                t = times.setdefault((dt, geo, "other"), [0.0])
                t[0] += o_ms
                old = f"other tree {o_ms:.4f} ms, "
            else:
                k_ms = kc.device_ms(kern, iters=10)
            l_ms = kc.device_ms(lib, iters=10)
            ops, nbytes = kc.gemm_work(m, n, k, dt == "int8", res)
            b_ms, by = (kc.bound_ms(0.0, nbytes, ops) if dt == "int8"
                        else kc.bound_ms(ops, nbytes))
            t = times.setdefault((dt, geo), [0.0, 0.0, 0.0])
            t[0], t[1], t[2] = t[0] + k_ms, t[1] + l_ms, t[2] + b_ms
            unit = "TOPS" if dt == "int8" else "TFLOP/s"
            p = f" {plan(m, n, k, sms, dt, res)}" if plan else ""
            ep = "+".join(e for e, on in (("gelu", gelu), ("residual", res)) if on) or "bias"
            log(f"gemm {dt:4s} {name:13s} M {m} N {n} K {k} ({ep}){p}: {old}kernel {k_ms:.4f} ms "
                f"({ops / k_ms / 1e9:.1f} {unit}, {nbytes / k_ms / 1e6:.1f} GB/s), "
                f"{'torch._int_mm' if dt == 'int8' else 'torch.mm'} {l_ms:.4f} ms "
                f"({ops / l_ms / 1e9:.1f} {unit}), bound {b_ms:.4f} ms ({by}), {err} "
                f"(x{kc.GEMM_COUNT[geo]} per forward)")
            del kern, lib
            torch.cuda.empty_cache()
    tot = {}
    for row, (dt, geos) in TOTALS.items():
        if dt == "mixed":   # int8 where the int8 gates send the geometry, else bf16
            keys = [("int8" if geo in kc.GEMM_I8_GEOMS else "bf16", geo) for geo in kc.GEMM_COUNT]
        else:
            keys = [(dt, geo) for geo in geos]
        s = [sum(times[key][i] * kc.GEMM_COUNT[key[1]] for key in keys) for i in range(3)]
        tot[row] = {"kernel": s[0], "library": s[1], "bound": s[2]}
        old = ""
        if other is not None:
            tot[row]["other"] = sum(times[key + ("other",)][0] * kc.GEMM_COUNT[key[1]]
                                    for key in keys)
            old = f"other tree {tot[row]['other']:.4f} ms, "
        log(f"gemm per forward at batch {batch}, {row}: {old}kernel {s[0]:.4f} ms, "
            f"yardstick {s[1]:.4f} ms, bound {s[2]:.4f} ms")
    return tot


def run_handoff(batch: int, log: Callable[[str], None] = print,
                other=None) -> Dict[str, float]:
    """Times the hand-off GEMM at each kernel_check.GEMM_HO product (device
    ms) and, given ``other`` (another tree's kernels module), that tree's
    launcher on the same operands, in turns; beside torch.mm, the plain
    version (kernels.gemm_plain) and the bound (kernel_check.gemm_work).
    Returns the totals per 512^2 forward at ``batch`` (the fc1 products
    and the fronts' stacked ones, kernel_check.GEMM_COUNT calls each): ms of
    "kernel", "other", "library", "plain", "bound", "ops_ms", "bytes_ms"."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    sms = kernels._sm_count(dev.index or 0)
    tot = dict.fromkeys(("kernel", "other", "library", "plain", "bound", "ops_ms",
                         "bytes_ms"), 0.0)
    for name in kc.GEMM_HO:
        m, n, k, act = kc.gemm_ho_shape(name, batch)
        geo = name.split("_")[0]
        count = kc.GEMM_COUNT.get(geo, 0) if act != "gelu_pre" else 0
        g = lambda: torch.Generator().manual_seed(m + n + k)  # noqa: E731
        kern, plain, mm = kc.gemm_ho_calls(name, batch, g(), dev)
        times = {}
        differ = ""
        if other is not None:
            okern = kc.gemm_ho_calls(name, batch, g(), dev, mod=other)[0]
            times["other"], times["kernel"] = alternate(okern, kern)
            mine, theirs = kern(), okern()
            mine, theirs = (x if isinstance(x, tuple) else (x,) for x in (mine, theirs))
            differ = "outputs differing from the other tree's: " + ", ".join(
                f"{float((x != y).float().mean()):.3e}" for x, y in zip(mine, theirs)) + "; "
            del mine, theirs
        else:
            times["kernel"] = kc.device_ms(kern, iters=10)
        times["library"] = kc.device_ms(mm, iters=10)
        times["plain"] = kc.device_ms(plain, iters=3)
        ops, nbytes = kc.gemm_work(m, n, k, out_bytes=4 if act == "gelu_pre" else 2)
        b_ms, by = kc.bound_ms(ops, nbytes)
        plan = kernels.gemm_plan(m, n, k, sms)
        old = f"other tree {times['other']:.4f} ms, " if other is not None else ""
        log(f"gemm handoff {name:15s} M {m} N {n} K {k} ({act}) {plan}: {old}kernel "
            f"{times['kernel']:.4f} ms ({ops / times['kernel'] / 1e9:.1f} TFLOP/s), torch.mm "
            f"{times['library']:.4f} ms, plain {times['plain']:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}); {differ}(x{count} per forward)")
        for key in ("kernel", "other", "library", "plain"):
            tot[key] += times.get(key, 0.0) * count
        tot["bound"] += b_ms * count
        tot["ops_ms" if by == "operations" else "bytes_ms"] += b_ms * count
        del kern, plain, mm
        torch.cuda.empty_cache()
    old = f"other tree {tot['other']:.4f} ms, " if other is not None else ""
    log(f"gemm handoff per forward at batch {batch} (fc1 and the fronts' stacked products): "
        f"{old}kernel {tot['kernel']:.4f} ms, torch.mm {tot['library']:.4f} ms, plain "
        f"{tot['plain']:.4f} ms, bound {tot['bound']:.4f} ms")
    return tot


def run_f32(batch: int, log: Callable[[str], None] = print) -> Dict[str, Dict[str, float]]:
    """Times every f32 GEMM of kernel_check.gemm_f32_shapes; returns the
    per-forward totals in ms at 512^2 and 384^2: kernel, F.linear, bound."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    sms = kernels._sm_count(dev.index or 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    tot = {"512^2": [0.0, 0.0, 0.0], "384^2": [0.0, 0.0, 0.0]}
    for name, (m, n, k, gelu, res) in kc.gemm_f32_shapes(batch).items():
        geo = name.rsplit("_", 1)[0]
        cnt = kc.F32_GEMM_GEOMS[geo][2] if geo in kc.F32_GEMM_GEOMS else 0
        kern, _, lib = kc.gemm_f32_calls(name, batch, torch.Generator().manual_seed(m + n), dev)
        k_ms, l_ms = kc.device_ms(kern, iters=10), kc.device_ms(lib, iters=10)
        ops, nbytes = kc.gemm_f32_work(m, n, k, res)
        b_ms, by = kc.bound_ms(ops, nbytes, f32=True)
        if cnt:
            t = tot["384^2" if "_384_" in name else "512^2"]
            t[0], t[1], t[2] = t[0] + k_ms * cnt, t[1] + l_ms * cnt, t[2] + b_ms * cnt
        ep = "+".join(e for e, on in ((gelu or "", gelu), ("residual", res)) if on) or "bias"
        p = (f" bn {kernels.gemm_plan(m, n, k, sms, 'f32', res).bn}"
             if "f32" in kernels.GEMM_BN else "")
        log(f"gemm f32  {name:20s} M {m} N {n} K {k} ({ep}){p}: kernel {k_ms:.4f} ms "
            f"({ops / k_ms / 1e9:.1f} TFLOP/s, {nbytes / k_ms / 1e6:.1f} GB/s), F.linear f32 "
            f"{l_ms:.4f} ms ({ops / l_ms / 1e9:.1f} TFLOP/s), bound {b_ms:.4f} ms ({by}) "
            f"(x{cnt} per f32 forward)")
        del kern, lib
        torch.cuda.empty_cache()
    out = {}
    for size, (k_ms, l_ms, b_ms) in tot.items():
        out[size] = {"kernel": k_ms, "library": l_ms, "bound": b_ms}
        log(f"gemm f32 per f32 forward at {size}, batch {batch}: kernel {k_ms:.4f} ms, F.linear "
            f"f32 {l_ms:.4f} ms, bound {b_ms:.4f} ms")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def run_lnq8(batch: int, log: Callable[[str], None] = print) -> Dict[str, float]:
    """Times kernels.layernorm_q8 at each kernel_check.LNQ8 geometry (device
    ms) against its plain version and its bytes bound; returns the totals
    per int8 forward in ms (bf16 rows: kernel, plain, bound)."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.ops.fused_block_t import layer_norm
    from spegnet_tpu_torch.ops.fused_block_t_i8 import quant_tokens

    dev = torch.device("cuda")
    tot = [0.0, 0.0, 0.0]
    with torch.inference_mode():
        for name, (c, n, f32, calls) in kc.LNQ8.items():
            x, w, b = kc.lnq8_inputs(name, batch, torch.Generator().manual_seed(2), dev)
            k_ms = kc.device_ms(lambda: kernels.layernorm_q8(x, w, b, 1e-6), iters=20)
            p_ms = kc.device_ms(lambda: quant_tokens(layer_norm(x, w, b, 1e-6)), iters=5)
            nbytes = kc.lnq8_bytes(name, batch)
            b_ms = nbytes / kc.PEAK_BYTES * 1e3
            if not f32:
                tot = [tot[0] + k_ms * calls, tot[1] + p_ms * calls, tot[2] + b_ms * calls]
            log(f"layernorm_q8 {name:10s} rows {x.shape[0]} C {c} {'f32' if f32 else 'bf16'}: "
                f"kernel {k_ms * 1e3:.2f} us ({nbytes / k_ms / 1e6:.1f} GB/s), plain "
                f"{p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us (bytes) (x{calls} per int8 "
                f"forward{' in f32' if f32 else ''})")
            del x, w, b
    log(f"layernorm_q8 per bf16 int8 forward, batch {batch}: kernel {tot[0]:.4f} ms, plain "
        f"{tot[1]:.4f} ms, bound {tot[2]:.4f} ms")
    return {"kernel": tot[0], "plain": tot[1], "bound": tot[2]}


def lnq8_codes(batch: int):
    """name -> (codes, scales) of kernels.layernorm_q8 on the CPU, on seeded
    rows at each kernel_check.LNQ8 geometry."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")
    out = {}
    for name in kc.LNQ8:
        x, w, b = kc.lnq8_inputs(name, batch, torch.Generator().manual_seed(4), dev)
        q, sc = kernels.layernorm_q8(x, w, b, 1e-6)
        out[name] = (q.cpu(), sc.cpu())
    return out


def compare_codes(got, ref, log: Callable[[str], None] = print) -> None:
    """The share of codes of ``got`` that differ from ``ref``'s (each
    :func:`lnq8_codes`), the largest difference, and the scales that differ."""
    for name, (q, sc) in got.items():
        rq, rs = ref[name]
        dq = (q.int() - rq.int()).abs()
        log(f"layernorm_q8 codes {name:10s}: {float((dq > 0).float().mean()):.3e} of "
            f"{q.numel()} differ (max {int(dq.max())}), scales differ "
            f"{int((sc != rs).sum())} of {sc.numel()} (max rel "
            f"{float(((sc - rs).abs() / rs).max()):.3e})")


def digests(batch: int) -> Dict[str, str]:
    """name -> SHA-256 of the output bytes of each GEMM launcher on seeded
    inputs: every forward product of :func:`run` (bf16 and, where the int8
    gates send it, int8 with both dequant orders), the fc1 product through
    gemm_gelu_pre (pre-activation and GELU) and the block backward's dX
    products (dz through gemm_gelu_grad, dh2, da, dh1) at each block
    geometry."""
    import hashlib

    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels

    dev = torch.device("cuda")

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    def bf(shape, g, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, torch.bfloat16)

    out = {}
    for name, (m, n, k, gelu, res) in kc.gemm_shapes(batch).items():
        g = torch.Generator().manual_seed(m + n + k)
        a, w, b = bf((m, k), g), bf((n, k), g, k ** -0.5), bf((n,), g, 0.1)
        r = bf((m, n), g) if res else None
        out[f"bf16 {name}"] = sha(kernels.gemm(a, w, b, residual=r, gelu=gelu))
        if gelu:
            out[f"bf16 {name} gelu_pre"] = sha(*kernels.gemm_gelu_pre(a, w, b))
        if name.split("_")[0] in kc.GEMM_I8_GEOMS:
            qa = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(dev)
            qw = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(dev)
            sa, sw = torch.rand(m, generator=g).to(dev), torch.rand(n, generator=g).to(dev)
            bias = torch.randn((n,), generator=g).to(dev)
            for first in (True, False):
                out[f"int8 {name} sw_first {first}"] = sha(kernels.gemm_i8(
                    qa, sa, qw, sw, bias, residual=r, gelu=gelu, sw_first=first))
        del a, w, r
        torch.cuda.empty_cache()
    for geo in ("stage1", "stage2", "stage3", "stage4"):
        c, n = kc.BLOCKS[geo][1], kc.BLOCKS[geo][4]
        m = batch * n
        g = torch.Generator().manual_seed(m + c)
        dy, z = bf((m, c), g), bf((m, 4 * c), g)
        out[f"bf16 {geo}_dz gelu_grad"] = sha(kernels.gemm_gelu_grad(dy, bf((4 * c, c), g), z))
        for prod, kk in (("dh2", 4 * c), ("da", c), ("dh1", 3 * c)):
            out[f"bf16 {geo}_{prod}"] = sha(kernels.gemm(bf((m, kk), g), bf((c, kk), g)))
        del dy, z
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--digests", help="write the outputs' SHA-256 here (JSON)")
    ap.add_argument("--against", help="compare the outputs' SHA-256 with this file")
    ap.add_argument("--tree", help="time this other tree's launchers beside this tree's")
    ap.add_argument("--handoff", action="store_true", help="time the hand-off GEMM")
    ap.add_argument("--f32", action="store_true", help="time the f32 GEMM")
    ap.add_argument("--lnq8", action="store_true", help="time the LayerNorm + quant pass")
    ap.add_argument("--codes", help="write the LayerNorm + quant codes here (torch.save)")
    ap.add_argument("--codes-against", help="compare the codes with this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_bench needs a CUDA device")
    print(f"{torch.cuda.get_device_name(0)}, batch {args.batch}", flush=True)
    say = lambda s: print(s, flush=True)  # noqa: E731
    if args.codes or args.codes_against:
        got = lnq8_codes(args.batch)
        if args.codes:
            torch.save(got, args.codes)
        if args.codes_against:
            compare_codes(got, torch.load(args.codes_against), say)
    if args.f32 or args.lnq8:
        if args.f32:
            run_f32(args.batch, say)
        if args.lnq8:
            run_lnq8(args.batch, say)
        return
    if args.codes or args.codes_against:
        return
    other = None
    if args.tree:
        from pathlib import Path

        from spegnet_tpu_torch.utils.window_ab import other_kernels

        other = other_kernels(Path(args.tree))
    with torch.inference_mode():
        if args.handoff:
            run_handoff(args.batch, say, other)
            return
        if args.digests or args.against:
            import json

            got = digests(args.batch)
            if args.digests:
                with open(args.digests, "w") as f:
                    json.dump(got, f, indent=1)
            if args.against:
                with open(args.against) as f:
                    ref = json.load(f)
                differ = sorted(k for k in ref if got.get(k) != ref[k])
                print(f"gemm digests: {len(ref) - len(differ)} of {len(ref)} outputs "
                      f"bit-equal to {args.against}; differ: {differ}", flush=True)
            return
        run(args.batch, say, other)


if __name__ == "__main__":
    main()
