#!/usr/bin/env python3
"""Time the port's flash-attention kernels (K1, K2, K3) over T and D.

    python3 tools/torch_flash_attention_sweep.py

Needs an NVIDIA card.  For each T in {512, 2048, 8192} and D in {64,
128}, at 32 heads with B chosen so B*T = 4096 tokens (B = 1 at T = 8192),
causal, bf16: each kernel's device time (CUDA events over a few
launches), its bound (the larger of the products' operations on the
unmasked pairs at 989 TFLOP/s bf16 and each input read once, each output
written once at 3.35 TB/s) and the share of the bound reached, beside
``scaled_dot_product_attention`` forward and backward (a yardstick that
the port never calls).  The last line is a JSON record of every row.
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def events_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import flash_attention as fa

    fa.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    h, rows = 32, []
    for t in (512, 2048, 8192):
        for d in (64, 128):
            b = max(1, 4096 // t)
            bh, scale = b * h, d ** -0.5

            def make(s):
                return torch.from_numpy((rng.standard_normal((bh, t, d)) * s)
                                        .astype(np.float32)).to(
                    dev, torch.bfloat16)

            q, k, v, do = make(0.5), make(0.5), make(1.0), make(1.0)
            out, lse = fa._fwd_kernel(q, k, v, scale, True)
            delta = (do.float() * out.float()).sum(-1)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

            n = 10 if t < 8192 else 3
            ms = {"K1": events_ms(
                lambda: fa._fwd_kernel(q, k, v, scale, True), n),
                "K2": events_ms(lambda: fa._run(
                    "mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, lse,
                    delta, dq, bh, t, t, d, scale, 1, 1), n),
                "K3": events_ms(lambda: fa._run(
                    "mxtt_flash_bwd_dkv", "dkv_launches", q, k, v, do,
                    lse, delta, dk, dv, bh, t, t, d, scale, 1, 1), n)}
            q4, k4, v4 = (x.reshape(b, h, t, d).requires_grad_()
                          for x in (q, k, v))
            lib_fwd = events_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 10)
            lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True)
            lib_bwd = events_ms(lambda: torch.autograd.grad(
                lib_out, (q4, k4, v4), do.reshape(b, h, t, d),
                retain_graph=True), 10)
            pairs = bh * t * (t + 1) // 2
            tile, lrow = bh * t * d * 2, bh * t * 4
            work = {"K1": (2, 4 * tile + lrow), "K2": (3, 5 * tile + 2 * lrow),
                    "K3": (4, 6 * tile + 2 * lrow)}
            row = {"T": t, "D": d, "B": b, "H": h, "sdpa_fwd_ms": lib_fwd,
                   "sdpa_bwd_ms": lib_bwd}
            for name, (products, n_bytes) in work.items():
                t_ops = products * 2 * pairs * d / BF16_FLOPS * 1e3
                bound = max(t_ops, n_bytes / HBM_BYTES_PER_S * 1e3)
                row[name] = {"ms": ms[name], "bound_ms": bound,
                             "share": bound / ms[name]}
            rows.append(row)
            print("T %5d D %3d B %d: " % (t, d, b) + ", ".join(
                "%s %.3f ms (%.1f%% of bound)"
                % (name, ms[name], 100 * row[name]["share"])
                for name in ("K1", "K2", "K3"))
                + "; sdpa fwd %.3f ms, bwd %.3f ms" % (lib_fwd, lib_bwd),
                flush=True)
            del q, k, v, do, out, lse, delta, q4, k4, v4, lib_out, dq, dk, dv
            torch.cuda.empty_cache()
    print(json.dumps({"sweep": rows, "device": torch.cuda.get_device_name(0),
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
