#!/usr/bin/env python3
"""Time the port's flash-attention kernels (K1, K2, K3) over T and D.

    python3 tools/torch_flash_attention_sweep.py

Needs an NVIDIA card.  For each T in {512, 2048, 8192}, D in {64, 128}
and causal or not, at 32 heads with B chosen so B*T = 4096 tokens (B = 1
at T = 8192), bf16: each kernel's device time (CUDA events over a few
launches), its rate in TFLOP/s of its products on the unmasked pairs,
its bound (the larger of those operations at 989 TFLOP/s bf16 and each
input read once, each output written once at 3.35 TB/s) and the share of
the bound reached, beside ``scaled_dot_product_attention`` forward and
backward (a yardstick that the port never calls; its forward's rate is
counted on K1's operations, its backward's on K2's and K3's together).
The last line is a JSON record of every row.
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


def sweep_row(fa, dev, rng, t, d, h, causal):
    """One (T, D, causal) row: K1-K3 and sdpa timed on the same inputs."""
    import torch
    import torch.nn.functional as F

    b = max(1, 4096 // t)
    bh, scale, c = b * h, d ** -0.5, int(causal)

    def make(s):
        return torch.from_numpy((rng.standard_normal((bh, t, d)) * s)
                                .astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v, do = make(0.5), make(0.5), make(1.0), make(1.0)
    out, lse = fa._fwd_kernel(q, k, v, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    n = 10 if t < 8192 else 3
    ms = {"K1": events_ms(lambda: fa._fwd_kernel(q, k, v, scale, causal), n),
          "K2": events_ms(lambda: fa._run(
              "mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, lse, delta,
              dq, bh, t, t, d, scale, c, 1), n),
          "K3": events_ms(lambda: fa._run(
              "mxtt_flash_bwd_dkv", "dkv_launches", q, k, v, do, lse, delta,
              dk, dv, bh, t, t, d, scale, c, 1), n)}
    q4, k4, v4 = (x.reshape(b, h, t, d).requires_grad_() for x in (q, k, v))
    lib_fwd = events_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 10)
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    lib_bwd = events_ms(lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), do.reshape(b, h, t, d), retain_graph=True),
        10)
    pairs = bh * t * (t + 1) // 2 if causal else bh * t * t
    tile, lrow = bh * t * d * 2, bh * t * 4
    work = {"K1": (2, 4 * tile + lrow), "K2": (3, 5 * tile + 2 * lrow),
            "K3": (4, 6 * tile + 2 * lrow)}
    row = {"T": t, "D": d, "B": b, "H": h, "causal": causal,
           "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
           "sdpa_fwd_tflops": 2 * 2 * pairs * d / lib_fwd / 1e9,
           "sdpa_bwd_tflops": 5 * 2 * pairs * d / lib_bwd / 1e9}
    for name, (products, n_bytes) in work.items():
        flops = products * 2 * pairs * d
        t_ops = flops / BF16_FLOPS * 1e3
        bound = max(t_ops, n_bytes / HBM_BYTES_PER_S * 1e3)
        row[name] = {"ms": ms[name], "tflops": flops / ms[name] / 1e9,
                     "bound_ms": bound, "share": bound / ms[name]}
    print("T %5d D %3d causal %d B %d: " % (t, d, c, b) + ", ".join(
        "%s %.4f ms %.1f TFLOP/s (%.1f%% of bound)"
        % (name, row[name]["ms"], row[name]["tflops"],
           100 * row[name]["share"]) for name in ("K1", "K2", "K3"))
        + "; sdpa fwd %.4f ms %.1f TFLOP/s, bwd %.4f ms %.1f TFLOP/s"
        % (lib_fwd, row["sdpa_fwd_tflops"], lib_bwd,
           row["sdpa_bwd_tflops"]), flush=True)
    return row


def main():
    import torch

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
            for causal in (True, False):
                rows.append(sweep_row(fa, dev, rng, t, d, h, causal))
                torch.cuda.empty_cache()
    print(json.dumps({"sweep": rows, "device": torch.cuda.get_device_name(0),
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
