"""Device time of PED decoder block 2's kernels, bf16 and int8, piece by
piece, beside cuDNN and the roofline bound.

    python -m spegnet_tpu_torch.utils.decoder_bench [--batch 8] [--sizes 512 384]
        [--against build/parent] [--digests OUT.json] [--digests-against REF.json]

Per input size (x1 [B, S, S, 128], S = size / 2, Cm 64), device ms
(kernel_check.device_ms, torch.profiler) of:

* bf16 (csrc/decoder_block.cu): conv1 (``kernels.dec_upconv``, the 2x
  bilinear sample built in the kernel), conv2 + head
  (``kernels.dec_conv_head``), and the block through ``fused_decoder_block``;
* int8 (csrc/decoder_i8.cu, ``model.int8_decoder``): the per-image quant,
  the border strips (``kernels.dec_strips``; beside them ``make_strips``,
  four thin f32 cuDNN convs, their plain version), conv1 with the paste
  (``kernels.polyconv1_i8``), conv2 + head (``kernels.conv2_i8_head``), and
  the block through ``fused_decoder_block``;
* the edge branch's Cm 128 kernels (csrc/decoder_block.cu ``dec128_kernel``,
  no model path) at each kernel_check.DEC_EDGE geometry whose 2S is the
  size: conv1 over up2(x) + up4(ef) (``kernels.upsample_conv3x3_bn_relu``),
  conv2 (``conv3x3_bn_relu``), conv2 + head (``conv3x3_bn_relu_head``) and
  the block through ``fused_decoder_block`` (without its head, as PED block
  1 runs), beside cuDNN's convs of the same block (``--against`` a tree
  with the one-tile Cm 128 kernel: its launchers on row-packed weights);
* cuDNN in bf16, channels-last, as the yardstick the port never calls:
  ``F.interpolate`` then ``F.conv2d`` for conv1, ``F.conv2d`` for conv2, and
  the 1x1 head as a third ``F.conv2d`` (no BN: the convolutions alone);
* the bound of each piece and of the block (kernel_check.bound_ms: the
  products at the bf16 / int8 peak, each input read and each output written
  once).

``--against TREE`` loads another tree's ``spegnet_tpu_torch/kernels.py``
under a module name of its own (it builds its own library, e.g. the parent
commit unpacked with ``git archive``) and times its decoder kernels on the
same inputs, in turns with this tree's (this, other, other, this) -- the
edge branch's through the other tree's launchers, its weights packed as that
tree's fused_decoder_block packs them -- and holds the int8 pieces of the two builds bit for bit given ``make_strips``'
strips: x codes, sx, y1, the strip scales, pred.  ``--digests`` writes, and
``--digests-against`` compares with a file written before, the SHA-256 of
those pieces at every kernel_check.DEC_I8 geometry (batch 2, seed 1).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict


def library(x, p) -> Callable[[], object]:
    """cuDNN's bf16 channels-last calls for block 2 (no edge branch) or the
    edge branch: interpolate + conv1 (+ the edge features' interpolate and
    conv), conv2 and, with a head, the 1x1 head conv."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    s = x.shape[1]
    dt = x.dtype

    def cl(w):
        return w.to(dt).contiguous(memory_format=torch.channels_last)

    w1, w2 = cl(p.w1), cl(p.w2)
    head = None if p.head_w is None else cl(p.head_w)

    def call(ef=None, we=None):
        up = F.interpolate(xc, size=(2 * s, 2 * s), mode="bilinear", align_corners=False)
        y = F.conv2d(up, w1, padding=1)
        if ef is not None:
            e = F.interpolate(ef.permute(0, 3, 1, 2), size=(2 * s, 2 * s), mode="bilinear",
                              align_corners=False)
            y = y + F.conv2d(e, we, padding=1)
        y = F.conv2d(y, w2, padding=1)
        return y if head is None else F.conv2d(y, head)

    return call


def library_call(case_name: str, batch: int, g, dev) -> Callable[[], object]:
    """The cuDNN yardstick of a kernel_check decoder geometry (DECODER,
    DEC_EDGE or DEC_I8) on seeded inputs."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc

    if case_name in kc.DEC_EDGE:
        s, cin, ce, cm = kc.DEC_EDGE[case_name]
        p = kc.decoder_params(cin, cm, g, dev, ce=ce, head=False)
        x = torch.randn((batch, s, s, cin), generator=g).to(dev, torch.bfloat16)
        ef = torch.randn((batch, s // 2, s // 2, ce), generator=g).to(dev, torch.bfloat16)
        we = p.we.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        call = library(x, p)
        return lambda: call(ef, we)
    s, cin, cm = {**kc.DECODER, **kc.DEC_I8}[case_name]
    p = kc.decoder_params(cin, cm, g, dev)
    x = torch.randn((batch, s, s, cin), generator=g).to(dev, torch.bfloat16)
    return library(x, p)


def _conv_bound(kc, px: int, k: int, in_bytes: float, out_bytes: float, int8: bool = False):
    """(ms, side) of a 3x3 conv of px output pixels, K = 9 Cin, 64 outputs."""
    ops = 2.0 * px * k * 64
    wbytes = k * 64 * (1 if int8 else 2)
    return kc.bound_ms(0.0 if int8 else ops, in_bytes + out_bytes + wbytes, ops if int8 else 0.0)


def pieces(kernels, kc, fd, s: int, batch: int, dev, other=None) -> Dict[str, Callable]:
    """name -> zero-argument call of each piece at x1 [batch, s, s, 128];
    with ``other`` (another tree's kernels module) its pieces too, under
    ``old `` names."""
    import torch

    g = torch.Generator().manual_seed(2)
    x, q, p = kc.dec_i8_inputs((s, 128, 64), batch, g, dev)
    s1, t1 = (v.contiguous() for v in fd.fold_bn(p.b1, *p.bn1))
    s2, t2 = (v.contiguous() for v in fd.fold_bn(p.b2, *p.bn2))
    hw = p.head_w.reshape(-1).float().contiguous()
    hb = p.head_b.reshape(-1).float().contiguous()
    wt1, wt2 = fd._pack_conv_t(p.w1.to(x.dtype)), fd._pack_conv_t(p.w2.to(x.dtype))
    sh = fd.strip_height(s)
    y1 = kernels.dec_upconv(x, wt1, s1, t1)
    xq, sx = kernels.quant_image_i8(x)
    strips = kernels.dec_strips(x, q.k1t)
    y1q, amax = kernels.polyconv1_i8(xq, sx, q.w1t, q.sw1, q.s1, q.t1, strips, sh)
    lib = library(x, p)
    out = {
        "bf16 conv1": lambda: kernels.dec_upconv(x, wt1, s1, t1),
        "bf16 conv2+head": lambda: kernels.dec_conv_head(y1, wt2, s2, t2, hw, hb),
        "bf16 block": lambda: fd.fused_decoder_block(x, p),
        "int8 quant": lambda: kernels.quant_image_i8(x),
        "int8 strips": lambda: kernels.dec_strips(x, q.k1t),
        "make_strips (cuDNN f32)": lambda: torch.stack(fd.make_strips(x, q.k1, dtype=x.dtype)),
        "int8 conv1": lambda: kernels.polyconv1_i8(xq, sx, q.w1t, q.sw1, q.s1, q.t1, strips, sh),
        "int8 conv2+head": lambda: kernels.conv2_i8_head(y1q, sh, q.w2q, q.sw2, q.t2, q.hw, q.hb,
                                                         amax=amax),
        "int8 block": lambda: fd.fused_decoder_block(x, p, int8=True, q=q),
        "cuDNN block": lib,
    }
    if other is not None:
        oy1 = other.dec_upconv(x, wt1, s1, t1)
        oxq, osx = other.quant_image_i8(x)
        ostrips = other.dec_strips(x, q.k1t)
        oy1q, oamax = other.polyconv1_i8(oxq, osx, q.w1t, q.sw1, q.s1, q.t1, ostrips, sh)
        out.update({
            "old bf16 conv1": lambda: other.dec_upconv(x, wt1, s1, t1),
            "old bf16 conv2+head": lambda: other.dec_conv_head(oy1, wt2, s2, t2, hw, hb),
            "old int8 quant": lambda: other.quant_image_i8(x),
            "old int8 strips": lambda: other.dec_strips(x, q.k1t),
            "old int8 conv1": lambda: other.polyconv1_i8(oxq, osx, q.w1t, q.sw1, q.s1, q.t1,
                                                         ostrips, sh),
            "old int8 conv2+head": lambda: other.conv2_i8_head(oy1q, sh, q.w2q, q.sw2, q.t2,
                                                               q.hw, q.hb, amax=oamax),
        })
    return out


def _pack_rows(w):
    """[Cout, Cin, 3, 3] -> [9 Cin, Cout], rows tap-major (dy, dx, ci): the
    Cm 128 weights of the one-tile kernel the edge branch ran on before the
    Cm 128 frame (for ``--against`` a tree that has it)."""
    return w.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0]).contiguous()


def edge_pieces(kernels, kc, fd, name: str, batch: int, dev,
                other=None) -> Dict[str, Callable]:
    """name -> zero-argument call of each edge-branch piece at
    kernel_check.DEC_EDGE geometry ``name``; with ``other`` its pieces under
    ``old `` names."""
    import torch

    g = torch.Generator().manual_seed(2)
    s, cin, ce, cm = kc.DEC_EDGE[name]
    p = kc.decoder_params(cin, cm, g, dev, ce=ce, head=True)
    x = torch.randn((batch, s, s, cin), generator=g).to(dev, torch.bfloat16)
    ef = torch.randn((batch, s // 2, s // 2, ce), generator=g).to(dev, torch.bfloat16)
    s1, t1 = (v.contiguous() for v in fd.fold_bn(p.b1, *p.bn1))
    s2, t2 = (v.contiguous() for v in fd.fold_bn(p.b2, *p.bn2))
    hw = p.head_w.reshape(-1).float().contiguous()
    hb = p.head_b.reshape(-1).float().contiguous()
    bf = torch.bfloat16
    w1, we, w2 = (kernels.pack_dec128(v.to(bf)) for v in (p.w1, p.we, p.w2))
    y1 = kernels.upsample_conv3x3_bn_relu(x, w1, s1, t1, ef, we)
    pb = p._replace(head_w=None, head_b=None)
    we_cl = p.we.to(bf).contiguous(memory_format=torch.channels_last)
    lib = library(x, pb)
    out = {
        "edge conv1": lambda: kernels.upsample_conv3x3_bn_relu(x, w1, s1, t1, ef, we),
        "edge conv2": lambda: kernels.conv3x3_bn_relu(y1, w2, s2, t2),
        "edge conv2+head": lambda: kernels.conv3x3_bn_relu_head(y1, w2, s2, t2, hw, hb),
        "edge block": lambda: fd.fused_decoder_block(x, pb, ef),
        "cuDNN edge block": lambda: lib(ef, we_cl),
    }
    if other is not None:
        # a tree with the Cm 128 frame takes its packing, an older one rows
        pack = getattr(other, "pack_dec128", _pack_rows)
        o1, oe, o2 = (pack(v.to(bf)) for v in (p.w1, p.we, p.w2))
        oy1 = other.upsample_conv3x3_bn_relu(x, o1, s1, t1, ef=ef, we=oe)
        out.update({
            "old edge conv1": lambda: other.upsample_conv3x3_bn_relu(x, o1, s1, t1, ef=ef, we=oe),
            "old edge conv2": lambda: other.conv3x3_bn_relu(oy1, o2, s2, t2),
            "old edge conv2+head": lambda: other.conv3x3_bn_relu_head(oy1, o2, s2, t2, hw, hb),
            # as that tree's fused_decoder_block: the weights packed per call
            "old edge block": lambda: other.conv3x3_bn_relu(
                other.upsample_conv3x3_bn_relu(x, pack(p.w1.to(bf)), s1, t1, ef=ef,
                                               we=pack(p.we.to(bf))),
                pack(p.w2.to(bf)), s2, t2),
        })
    return out


def edge_bounds(kc, name: str, batch: int) -> Dict[str, tuple]:
    """(ms, side) of each edge piece's bound at DEC_EDGE geometry ``name``:
    the products at the bf16 peak, each input read and output written once."""
    s, cin, ce, cm = kc.DEC_EDGE[name]
    px = batch * (2 * s) ** 2
    x_bytes = batch * (s * s * cin + (s // 2) ** 2 * ce) * 2
    conv2 = (2.0 * px * 9 * cm * cm, px * cm * 2 + 9 * cm * cm * 2)
    return {
        "edge conv1": kc.bound_ms(2.0 * px * 9 * (cin + ce) * cm,
                                  x_bytes + 9 * (cin + ce) * cm * 2 + px * cm * 2),
        "edge conv2": kc.bound_ms(conv2[0], conv2[1] + px * cm * 2),
        "edge conv2+head": kc.bound_ms(conv2[0], conv2[1] + px * 2),
        "edge block": kc.bound_ms(*kc.work(name, batch)),
        "cuDNN edge block": kc.bound_ms(*kc.work(name, batch)),
    }


def bounds(kc, s: int, batch: int) -> Dict[str, tuple]:
    """(ms, side) of each piece's bound at x1 [batch, s, s, 128]."""
    cells, px = batch * s * s, batch * (2 * s) ** 2
    out = {
        "bf16 conv1": _conv_bound(kc, px, 9 * 128, cells * 128 * 2, px * 64 * 2),
        "bf16 conv2+head": _conv_bound(kc, px, 9 * 64, px * 64 * 2, px * 2),
        "int8 quant": kc.bound_ms(0.0, cells * 128 * 3.0),
        # 4 strips x 2S pixels x 64 channels, 2 rows x 3 taps x 128 inputs;
        # x's two outermost rows / columns read, the strips written
        "int8 strips": kc.bound_ms(2.0 * batch * 4 * 2 * s * 64 * 6 * 128,
                                   batch * 4 * 2 * s * 128 * 2 + batch * 4 * 2 * s * 64 * 2),
        "int8 conv1": _conv_bound(kc, cells * 4, 9 * 128, cells * 128, px * 64 * 2, int8=True),
        "int8 conv2+head": _conv_bound(kc, px, 9 * 64, px * 64 * 2, px * 2, int8=True),
    }
    out["bf16 block"] = kc.bound_ms(*_block_work(s, batch))
    ops, flops8, nbytes8 = _block_i8_work(s, batch)
    out["int8 block"] = kc.bound_ms(flops8, nbytes8, ops)
    out["cuDNN block"] = out["bf16 block"]
    return out


def _block_work(s, batch):
    """kernel_check.work of block 2 at x1 [batch, s, s, 128]."""
    px = batch * (2 * s) ** 2
    cin, cm = 128, 64
    flops = 2.0 * px * (9 * cin * cm + 9 * cm * cm + cm)
    return flops, batch * s * s * cin * 2 + 2 * (9 * cin * cm + 9 * cm * cm + cm) + px * 2


def _block_i8_work(s, batch):
    """kernel_check.i8_work of the int8 block at x1 [batch, s, s, 128]."""
    cells, px = batch * s * s, batch * (2 * s) ** 2
    cin, cm = 128, 64
    ops = 2.0 * cells * 9 * cin * 4 * cm + 2.0 * px * 9 * cm * cm
    wbytes = 9 * cin * 4 * cm + 9 * cm * cm + 4 * (4 * cm + 4 * cm)
    return ops, 2.0 * px * cm, cells * cin * 2 + wbytes + px * 2


def other_kernels(tree: Path):
    """``tree``'s spegnet_tpu_torch/kernels.py as a module of its own."""
    path = tree.resolve() / "spegnet_tpu_torch" / "kernels.py"
    spec = importlib.util.spec_from_file_location("decoder_bench_other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load()
    return mod


def i8_bits(kernels, kc, fd, name: str, dev, other=None) -> Dict[str, object]:
    """The int8 pieces (x codes, sx, y1, strip scales, pred) of this build
    given make_strips' strips, on kernel_check.dec_i8_inputs(name, 2, seed
    1); with ``other``, that build's pieces through its own launchers."""
    import torch

    x, q, _ = kc.dec_i8_inputs(name, 2, torch.Generator().manual_seed(1), dev)
    sh = fd.strip_height(x.shape[1])
    raw = fd.make_strips(x, q.k1, dtype=x.dtype)
    if other is None:
        got = fd.i8_parts_cuda(x, q, strips=torch.stack(raw))
        return {k: got[k] for k in ("xq", "sx", "y1", "sa", "pred")}
    xq, sx = other.quant_image_i8(x)
    y1, amax = other.polyconv1_i8(xq, sx, q.w1t, q.sw1, q.s1, q.t1, torch.stack(raw), sh)
    pred, sa = other.conv2_i8_head(y1, sh, q.w2q, q.sw2, q.t2, q.hw, q.hb, amax=amax)
    xq = xq[:, 1:-1, 1:-1]
    return {"xq": xq, "sx": sx, "y1": y1, "sa": sa, "pred": pred}


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _timed(kc, calls: Dict[str, Callable], bnd: Dict[str, tuple], turns: bool, tag: str,
           log) -> Dict[str, float]:
    """Device ms of each call (the least of its rounds; with ``turns`` the
    ``old `` calls in turns with the others: this, other, other, this),
    logged beside the other tree's and the bound; returns {piece: ms}."""
    names = [n for n in calls if not n.startswith("old ")]
    order = [names, [n for n in calls if n.startswith("old ")]] if turns else [names]
    ms = {}
    for rnd in (order + order[::-1]) if turns else order:
        for n in rnd:
            ms.setdefault(n, []).append(kc.device_ms(calls[n], iters=10, warmup=2))
    out = {n: min(v) for n, v in ms.items()}
    for n in names:
        b = bnd.get(n)
        old = out.get(f"old {n}")
        log(f"{tag} {n:24s}: device {out[n]:.4f} ms"
            + (f" (runs {', '.join(f'{v:.4f}' for v in ms[n])})" if turns else "")
            + ("" if old is None else f"; parent {old:.4f} ms (runs "
               f"{', '.join(f'{v:.4f}' for v in ms['old ' + n])})")
            + ("" if b is None else f"; bound {b[0]:.4f} ms ({b[1]})"))
    for n in calls:
        if n.startswith("old ") and n[4:] not in calls:
            log(f"{tag} {n:24s}: device {out[n]:.4f} ms")
    return out


def run(batch: int = 8, log=print, sizes=(512, 384), against: Path = None,
        digests: Path = None, digests_against: Path = None) -> Dict[str, Dict[str, float]]:
    """Time every piece at each input size (see the module docstring);
    returns {size or edge geometry: {piece: device ms}}."""
    import torch

    from spegnet_tpu_torch import kernel_check as kc
    from spegnet_tpu_torch import kernels
    from spegnet_tpu_torch.ops import fused_decoder as fd

    dev = torch.device("cuda")
    other = other_kernels(against) if against else None
    out = {}
    with torch.inference_mode():
        for size in sizes:
            s = size // 2
            calls = pieces(kernels, kc, fd, s, batch, dev, other)
            out[size] = _timed(kc, calls, bounds(kc, s, batch), other is not None,
                               f"decoder {size}^2 batch {batch}", log)
            del calls
            torch.cuda.empty_cache()
            for name in (n for n, v in kc.DEC_EDGE.items() if 4 * v[0] == size):
                calls = edge_pieces(kernels, kc, fd, name, batch, dev, other)
                out[name] = _timed(kc, calls, edge_bounds(kc, name, batch), other is not None,
                                   f"decoder {name} batch {batch}", log)
                del calls
                torch.cuda.empty_cache()
        if other is not None:
            for name in kc.DEC_I8:
                new, old = (i8_bits(kernels, kc, fd, name, dev, o) for o in (None, other))
                same = {k: bool(torch.equal(new[k], old[k])) for k in new}
                log(f"decoder int8 pieces {name} given make_strips' strips, bit-equal to the "
                    f"other build: {same}")
        if digests or digests_against:
            got = {name: {k: digest(v) for k, v in i8_bits(kernels, kc, fd, name, dev).items()}
                   for name in kc.DEC_I8}
            if digests:
                Path(digests).write_text(json.dumps(got, indent=1))
            if digests_against:
                ref = json.loads(Path(digests_against).read_text())
                for name in got:
                    log(f"decoder int8 pieces {name} digests equal to {digests_against}: "
                        f"{ {k: got[name][k] == ref.get(name, {}).get(k) for k in got[name]} }")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 384])
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--digests", type=Path, default=None)
    ap.add_argument("--digests-against", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decoder_bench needs a CUDA device")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    run(args.batch, sizes=args.sizes, against=args.against, digests=args.digests,
        digests_against=args.digests_against)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
