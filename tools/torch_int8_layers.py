#!/usr/bin/env python3
"""Time O6 (``mxnet_tpu_torch/csrc/int8_ops.cu``) layer by layer over
ResNet-50 v1's convolutions at batch 256.

    python3 tools/torch_int8_layers.py [--batch 256] [--iters 20]
        [--parent PATH/int8_ops.cu] [--out build/int8_layers.json]

Needs an NVIDIA card and nvcc.  The shapes are every ``nn.Conv2D`` of one
f32 forward of ``resnet50_v1`` at 224 x 224 (``chip_smoke.
quant_conv_shapes``), grouped into the distinct ones (about 20; the count
says how many of the 53 each is).  For each, with seeded random
operands and the f32 epilogue the layers run (``f32(acc) / denom``):

- O6 in the s8 mode (int8 activation) and in the f32 mode (the f32
  activation quantized in the load), each queued behind a sleep over
  ``--iters`` launches, beside its bound (the larger of the int8
  operations at 1,979 TOP/s and the bytes at 3.35 TB/s: the input read
  once at 1 or 4 bytes an element, the weights once, the f32 output
  written once) and its share of it, with the route's plan (tile width
  and K splits);
- the torch quantize of the f32 input alone (``quantize_int8``);
- with ``--parent``, the kernel built from that source (an earlier
  ``int8_ops.cu`` with the ``mxtt_int8_conv`` entry point) on the same
  s8 operands, timed in turns with the s8 mode (parent, change, change,
  parent) so that the two compare on one card.

Totals weigh each shape by its count.  All numbers are the card's, with
its name and power limit printed first.
"""
import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALE = 25.4


def distinct(shapes):
    """[(shape, count)] of ``shapes`` in first-seen order."""
    out, index = [], {}
    for s in shapes:
        key = (s["x"], s["w"], s["stride"], s["pad"], s["dilate"],
               s["groups"])
        if key in index:
            out[index[key]][1] += 1
        else:
            index[key] = len(out)
            out.append([s, 1])
    return out


def parent_launcher(source):
    """A launcher of the kernel built from ``source`` (the earlier single
    kernel's C interface) on (x, w, out, spec), f32 epilogue."""
    import torch

    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import int8_ops as io

    lib = ctypes.CDLL(_build.build(os.path.abspath(source)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mxtt_int8_conv.argtypes = [p] * 4 + [i] * 17 + [f, p]
    lib.mxtt_int8_conv.restype = i

    def run(x, w, out, s, denom):
        n, h, wd, c = x.shape
        o, kh, kw, _ = w.shape
        err = lib.mxtt_int8_conv(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), None, n, h, wd, c,
            o, kh, kw, out.shape[1], out.shape[2], *s["stride"], *s["pad"],
            *s["dilate"], s["groups"], 1, denom,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("the parent's kernel failed: %d" % err)
    return run, io


def layer_row(chip_smoke, io, s, count, iters, parent):
    """One distinct shape's readings."""
    import torch

    dev = torch.device("cuda", 0)
    x = torch.randint(-127, 128, s["x"], dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, s["w"], dtype=torch.int8, device=dev)
    xf = torch.randn(s["x"], device=dev)
    den = chip_smoke.QUANT_DENOM
    args = (s["stride"], s["pad"], s["dilate"], s["groups"])
    want = io.int8_conv(x, w, *args, denom=den)

    def change(_):
        io.int8_conv(x, w, *args, denom=den)

    def f32_mode(_):
        io.int8_conv(xf, w, *args, denom=den, scale=SCALE)

    ops, b1 = chip_smoke.conv_work(s, 1)
    _, b4 = chip_smoke.conv_work(s, 4)
    bound1, by1 = chip_smoke.int8_bound(ops, b1)
    bound4, by4 = chip_smoke.int8_bound(ops, b4)
    o, kh, kw, cg = s["w"]
    m = want.shape[0] * want.shape[1] * want.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"x": list(s["x"]), "w": list(s["w"]), "stride": s["stride"][0],
           "pad": s["pad"][0], "count": count, "m": m, "k": kh * kw * cg,
           "route_s8": io.route_for(False, cg, s["groups"], x.data_ptr(),
                                    w.data_ptr()),
           "plan": io.plan_wgmma(m, o // s["groups"], s["groups"],
                                 kh * kw * cg, sms),
           "bound_s8_ms": bound1, "bound_s8_by": by1,
           "bound_f32_ms": bound4, "bound_f32_by": by4}
    q = chip_smoke.queued_ms
    if parent is not None:
        run = parent
        out = torch.empty_like(want)

        def par(_):
            run(x, w, out, s, den)

        par(0)
        torch.cuda.synchronize()
        row["parent_equal"] = bool(torch.equal(out, want))
        t = [q(par, iters), q(change, iters), q(change, iters),
             q(par, iters)]
        row["parent_ms"] = (t[0] + t[3]) / 2
        row["s8_ms"] = (t[1] + t[2]) / 2
    else:
        row["s8_ms"] = q(change, iters)
    row["f32_ms"] = q(f32_mode, iters)
    row["quantize_ms"] = q(lambda _: io.quantize_int8(xf, SCALE), iters)
    return row


def main():
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "int8_layers.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import int8_ops as io

    smi = chip_smoke.nvidia_smi_line()
    print("card: %s" % smi, flush=True)
    dev = torch.device("cuda", 0)
    parent = parent_launcher(args.parent)[0] if args.parent else None
    with chip_smoke.exact_convs():
        net = chip_smoke.resnet_net(dev, "resnet50_v1", 17)
        shapes = chip_smoke.quant_conv_shapes(
            net, chip_smoke.quant_images(dev, args.batch, 60))
    del net
    torch.cuda.empty_cache()
    rows = []
    print("%-30s %-16s %3s %6s %9s %9s %7s %9s %9s %7s %9s %9s" % (
        "input (NHWC)", "weight (OHWI)", "n", "plan", "parent", "s8 ms",
        "s8 %", "bound s8", "f32 ms", "f32 %", "bound f32", "quantize"),
        flush=True)
    for s, count in distinct(shapes):
        r = layer_row(chip_smoke, io, s, count, args.iters, parent)
        rows.append(r)
        print("%-30s %-16s %3d %6s %9s %9.4f %6.1f%% %9.4f %9.4f %6.1f%% "
              "%9.4f %9.4f" % (
                  "%s s%d p%d" % (tuple(r["x"]), r["stride"], r["pad"]),
                  tuple(r["w"]), count, "%d/%d" % tuple(r["plan"]),
                  "%.4f" % r["parent_ms"] if parent else "-", r["s8_ms"],
                  100 * r["bound_s8_ms"] / r["s8_ms"], r["bound_s8_ms"],
                  r["f32_ms"], 100 * r["bound_f32_ms"] / r["f32_ms"],
                  r["bound_f32_ms"], r["quantize_ms"]), flush=True)
        torch.cuda.empty_cache()

    def total(key):
        return sum(r[key] * r["count"] for r in rows)

    tot = {k: total(k) for k in ("s8_ms", "f32_ms", "quantize_ms",
                                 "bound_s8_ms", "bound_f32_ms")}
    if parent:
        tot["parent_ms"] = total("parent_ms")
    print("over the %d convolutions: %s s8 mode %.4f ms (%.1f%% of %.4f), "
          "f32 mode %.4f ms (%.1f%% of %.4f); the torch quantize alone "
          "%.4f ms%s" % (
              sum(r["count"] for r in rows),
              "parent %.4f ms (%.1f%% of the s8 bound), " % (
                  tot["parent_ms"], 100 * tot["bound_s8_ms"]
                  / tot["parent_ms"]) if parent else "",
              tot["s8_ms"], 100 * tot["bound_s8_ms"] / tot["s8_ms"],
              tot["bound_s8_ms"], tot["f32_ms"],
              100 * tot["bound_f32_ms"] / tot["f32_ms"],
              tot["bound_f32_ms"], tot["quantize_ms"],
              "; the parent's quantize + kernel %.4f ms" % (
                  tot["quantize_ms"] + tot["parent_ms"]) if parent else ""),
          flush=True)
    ok = all(r.get("parent_equal", True) for r in rows)
    if not ok:
        print("the parent's kernel DIFFERS from the change's on some layer",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "batch": args.batch, "iters": args.iters,
                   "rows": rows, "total": tot}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
