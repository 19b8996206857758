"""Device time of the LayerNorm backward (kernels.layernorm_bwd,
csrc/hiera_block_bwd.cu) at each C of a 512^2 training step, beside its
bound, the library's backward and other trees' launchers.

    python -m spegnet_tpu_torch.utils.ln_bwd_bench [--batch 8] [--against TREE ...]

Per kernel_check.LN_BWD geometry (C 144 / 288 / 576 / 1152, rows batch x
N), with dres (the block backwards' LN1 / LN2) and without (the fronts'
LN1): device ms (kernel_check.device_ms, torch.profiler) of this tree's
launcher and of each ``--against`` tree's (its spegnet_tpu_torch/kernels.py
loaded as a module of its own, building its own library, e.g. the parent
commit unpacked with ``git archive``), in turns (this, others, others
reversed, this; the least of the rounds); the bytes bound (x, dy (, dres)
read and dx written once, bf16; the weight read and dw, db written once,
f32) at kernel_check.PEAK_BYTES; and the one PyTorch call computing the
same function, aten.native_layer_norm_backward on bf16 rows (with bf16
weight and bias: it takes no f32 weight beside bf16 rows; without dres).  Then the totals per training step, each
geometry's time times its calls (kernel_check.LN_BWD).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path
from typing import Dict


def run(batch: int = 8, against=(), log=print) -> Dict[str, Dict[str, float]]:
    """{tree: {geometry/dres: device ms}} with "this", each other tree and
    "library"; logs each geometry and the per-step totals."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.utils.decoder_bench import other_kernels

    dev = torch.device("cuda")
    mods = {"this": kernels}
    for i, tree in enumerate(against):
        mods[f"tree{i} {tree}"] = other_kernels(Path(tree))
    out = {k: {} for k in list(mods) + ["library", "bound"]}
    for name, (c, n, with_dres, plain) in kc.LN_BWD.items():
        for dres in (True, False):
            x, w, dy, dr = kc.ln_bwd_inputs(name, batch, torch.Generator().manual_seed(2), dev)
            dr = dr if dres else None
            calls = {k: (lambda m=m: m.layernorm_bwd(x, w, dy, 1e-6, dres=dr))
                     for k, m in mods.items()}
            # aten's LayerNorm takes no f32 weight beside bf16 rows: bf16 weights
            wb, bb = w.to(x.dtype), torch.zeros_like(w, dtype=x.dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], wb, bb, 1e-6)
            calls["library"] = lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [c], mean, rstd, wb, bb, [True, True, True])
            order = list(calls)
            ms = {k: [] for k in calls}
            for k in order + order[::-1]:
                ms[k].append(kc.device_ms(calls[k], iters=20))
            key = f"{name}/{'dres' if dres else 'plain'}"
            for k in calls:
                out[k][key] = min(ms[k])
            out["bound"][key] = kc.ln_bwd_bytes(name, batch, dres) / kc.PEAK_BYTES * 1e3
            log(f"ln_bwd {name} C {c} batch {batch} {'with' if dres else 'without'} dres: "
                + ", ".join(f"{k} {out[k][key]:.4f} ms (runs "
                            f"{', '.join(f'{v:.4f}' for v in ms[k])})" for k in calls)
                + f"; bound {out['bound'][key]:.4f} ms (bytes)")
    for k in out:
        tot = sum(out[k][f"{name}/dres"] * wd + out[k][f"{name}/plain"] * wp
                  for name, (_, _, wd, wp) in kc.LN_BWD.items())
        log(f"ln_bwd per 512^2 step at batch {batch} (93 calls): {k} {tot:.4f} ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ln_bwd_bench needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    run(args.batch, args.against)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
