#!/usr/bin/env python3
"""Time O4's routes (``mxnet_tpu_torch/csrc/box_nms.cu``) at the SSD
decode's shape.

    python3 tools/torch_nms_routes.py [--out build/nms_routes.json]

Needs an NVIDIA card and nvcc.  The input is what ``MultiBoxDetection``
hands O4 in ``chip_smoke.py``'s decode, made without the SSD net: the
7,220 anchors of a 38 x 38 map (``chip_smoke.SSD_SIZES``/``SSD_RATIOS``),
seeded random box offsets and class scores for 32 images, decoded and
sorted by ``chip_smoke.o4_inputs``; IoU threshold 0.45.

It prints the cluster route's device time (CUDA events over 20 launches)
at batch 32 and at batch 1, the time with every box invalid (no kept
row: the walk's chain of hops between CTAs alone), whether its keep mask
equals the two-pass route's bit for bit, and the two-pass route's passes
timed apart.  All in one process, so the times compare on one card.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

THRESH = 0.45


def decode_inputs(mx, ctx, batch, seed=0):
    """O4's input at the SSD decode's shape, from seeded offsets and
    scores (see the module docstring)."""
    import torch

    import chip_smoke

    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    side = -(-chip_smoke.SSD["image"] // 8)
    feat = mx.nd.zeros((1, 8, side, side), ctx=ctx)
    anchors = mx.nd.contrib.MultiBoxPrior(
        feat, sizes=chip_smoke.SSD_SIZES, ratios=chip_smoke.SSD_RATIOS,
        clip=True)
    a = anchors.shape[1]
    loc = torch.randn(batch, a * 4, generator=g) * 0.5
    logits = torch.randn(batch, chip_smoke.SSD["classes"] + 1, a,
                         generator=g) * 2.0
    probs = torch.softmax(logits, dim=1)
    nd = [mx.nd.array(t, ctx=ctx) for t in (probs, loc)]
    return chip_smoke.o4_inputs(nd[0], nd[1], anchors)


def cluster_row(box_nms, chip_smoke, coords, valid, want):
    """The cluster route's times and whether it equals ``want``."""
    import torch

    def run(i, bx=coords, vd=valid):
        return box_nms._launch(bx, vd, THRESH, "cluster")

    none = torch.zeros_like(valid)
    return {"equal": torch.equal(run(0), want),
            "ms": chip_smoke.cuda_ms(run, 20),
            "ms_batch1": chip_smoke.cuda_ms(
                lambda i: run(i, coords[:1], valid[:1]), 20),
            "ms_no_kept": chip_smoke.cuda_ms(
                lambda i: run(i, coords, none), 20)}


def main():
    import torch

    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import box_nms

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "nms_routes.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print("card: %s" % smi, flush=True)
    coords, valid = decode_inputs(mx, mx.gpu(0), chip_smoke.SSD["batch"])
    b, n = valid.shape
    want = box_nms._launch(coords, valid, THRESH, "two_pass")
    bound_ms, bound_by, pairs = chip_smoke.o4_bound(want.bool(), want.numel())
    print("input: %d images x %d boxes, %d kept, %d IoUs the walk needs, "
          "bound %.4f ms by %s" % (b, n, int(want.sum()), pairs, bound_ms,
                                   bound_by), flush=True)
    row = cluster_row(box_nms, chip_smoke, coords, valid, want)
    print("cluster route: %.4f ms at batch %d (%.1f%% of bound), %.4f ms at "
          "batch 1, %.4f ms with no box kept; keep mask %s"
          % (row["ms"], b, 100 * bound_ms / row["ms"], row["ms_batch1"],
             row["ms_no_kept"], "equal" if row["equal"] else "DIFFERS"),
          flush=True)
    doc = {"card": smi, "batch": b, "boxes": n, "kept": int(want.sum()),
           "bound_ms": bound_ms, "cluster": row,
           "two_pass": chip_smoke.o4_two_pass_times(coords, valid,
                                                    want.bool())}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    return 0 if row["equal"] and doc["two_pass"]["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
