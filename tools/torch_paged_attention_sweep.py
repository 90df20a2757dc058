#!/usr/bin/env python3
"""Time the port's paged-attention kernel (K4) over lanes and context.

    python3 tools/torch_paged_attention_sweep.py

Needs an NVIDIA card.  For each (lanes, context) at the Llama-3-8B
decode shape (32/8 heads, head_dim 128, bf16 pages of 16 tokens, f32
queries, a 256-page block table), prints the split the host picks
(``n_split``: blocks per (lane, kv-head) row tile) and the blocks that
launch, the device time of one call (CUDA events over 100 calls queued
behind a sleep, ``chip_smoke.queued_ms``, so the host's enqueue is not
timed; the split's combine included; four page sets rotating so no call
finds the last one's pages in L2), its byte bound at 3.35 TB/s, and the share of
the bound reached.  If the time stays flat as lanes grow, each block is
latency-bound and the card is not yet the limit; if it grows with lanes
at a fixed share, the card's bandwidth is.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke
    from mxnet_tpu_torch.ops import paged_attention as pa

    pa.build()
    dev = torch.device("cuda", 0)
    sms = pa.sm_count(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    h, kv, d, s_page, maxp, pages, n_rot = 32, 8, 128, 16, 256, 4097, 4
    rng = np.random.default_rng(0)
    rows = []
    for b, ctx in ((8, 256), (8, 1024), (8, 4096), (32, 1024), (64, 1024)):
        per_lane = ctx // s_page
        sets = []
        for _ in range(n_rot):
            kp, vp = (torch.empty((pages, s_page, kv, d),
                                  dtype=torch.bfloat16,
                                  device=dev).normal_() for _ in range(2))
            tbl = np.zeros((b, maxp), np.int32)
            for i in range(b):
                tbl[i, :per_lane] = rng.choice(np.arange(1, pages),
                                               per_lane, replace=False)
            q = torch.randn((b, 1, h, d), device=dev)
            pos = torch.full((b,), ctx - 1, dtype=torch.int32, device=dev)
            sets.append((q, kp, vp, torch.from_numpy(tbl).to(dev), pos))
        ms = chip_smoke.queued_ms(
            lambda i: pa.paged_attention(*sets[i % n_rot]), 100)
        n_bytes = 2 * b * ctx * kv * d * 2 + 2 * b * h * d * 4 \
            + b * maxp * 4 + b * 4
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        splits = pa.n_split(b, 1, h, kv, s_page, maxp, sms)
        rows.append({"lanes": b, "ctx": ctx, "n_split": splits,
                     "blocks": b * kv * splits, "ms": ms,
                     "bound_ms": bound_ms, "share": bound_ms / ms})
        print("lanes %3d ctx %5d n_split %2d blocks %4d: kernel %.4f ms, "
              "bound %.4f ms (%.1f%%)"
              % (b, ctx, splits, b * kv * splits, ms, bound_ms,
                 100 * bound_ms / ms), flush=True)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"sweep": rows,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
