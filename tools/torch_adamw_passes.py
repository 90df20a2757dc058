#!/usr/bin/env python3
"""Time adamw's weight rule on the card, pass by pass, on one large bf16
tensor: the optimizer's number path (host scalars, as ``gluon.Trainer``
runs it), its device-scalar path (``lr`` and ``t`` as device tensors, as
``parallel.JitTrainStep`` runs it, eager or in a captured graph), and
the alternative of putting the scalars into the denominator's ``+ eps``
pass.  A 0-d or broadcast tensor operand costs a pass its vectorized
kernel, so where the scalars go decides the cost.

    python3 tools/torch_adamw_passes.py [--elements N]

Prints the card's name and power limit, then one line per pass and per
whole rule (CUDA-event ms, median of 20).
"""
import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mxnet_tpu_torch import optimizer  # noqa: E402


def median_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * iters)]
    for i in range(iters):
        ev[2 * i].record()
        fn()
        ev[2 * i + 1].record()
    torch.cuda.synchronize()
    times = sorted(ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(iters))
    return times[len(times) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--elements", type=int, default=256 * 1024 * 1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_adamw_passes: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: not read")
    dev = torch.device("cuda")
    n, lr_f, wd, t_i = args.elements, 1e-4, 0.01, 5
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn(n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    m = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    v = (torch.rand(n, generator=gen, device=dev) * 1e-6).to(torch.bfloat16)
    opt = optimizer.create("adamw", learning_rate=lr_f, wd=wd)
    lr = torch.full((), lr_f, device=dev)
    t = torch.full((), t_i, dtype=torch.int32, device=dev)
    sc = opt._device_scalars(lr, t, wd)
    c = torch.sqrt(1.0 - opt.beta2 ** t.float()) / (1.0 - opt.beta1 ** t.float())
    inv_c, eps_c, neg_lr = 1.0 / c, opt.epsilon / c, (-lr).reshape(1)
    root = v.sqrt()
    denom = root.add(opt.epsilon)
    delta = torch.empty_like(w, dtype=torch.float32)

    def eps_pass_variant(wt, mean, var):
        d = torch.addcmul(eps_c, var.sqrt(), inv_c)
        dl = torch.empty_like(wt, dtype=torch.float32)
        torch.mul(wt, wd, out=dl)
        wt.addcmul_(dl.addcdiv_(mean, d), neg_lr)

    passes = [
        ("sqrt(v)", lambda: v.sqrt()),
        ("number: + eps", lambda: torch.add(root, opt.epsilon)),
        ("eps-pass variant: addcmul(eps/c, root, 1/c)",
         lambda: torch.addcmul(eps_c, root, inv_c)),
        ("number: w * -lr*wd into f32", lambda: torch.mul(w, -lr_f * wd,
                                                          out=delta)),
        ("device: w * (wd/c) into f32", lambda: torch.mul(w, sc["wd_c"],
                                                          out=delta)),
        ("both: delta += m / d", lambda: delta.addcdiv_(m, denom, value=1.0)),
        ("number: w += delta", lambda: torch.add(w, delta)),
        ("device: w += -lr_t * delta",
         lambda: torch.addcmul(w, delta, sc["neg_lr_t"])),
    ]
    for name, fn in passes:
        print("pass %-46s %.3f ms" % (name, median_ms(fn)), flush=True)
    states = [(m.clone(), v.clone()) for _ in range(3)]
    ws = [w.clone() for _ in range(3)]
    rules = [
        ("number path (host scalars)", lambda: opt._adam_step(
            ws[0], *states[0], lr_f, t_i, decay=lr_f * wd)),
        ("device-scalar path (kept)", lambda: opt._adam_step(
            ws[1], *states[1], lr, t, decay=lr * wd, wd=wd)),
        ("device scalars in the + eps pass",
         lambda: eps_pass_variant(ws[2], *states[2])),
    ]
    for name, fn in rules:
        print("rule %-46s %.3f ms over %d elements"
              % (name, median_ms(fn), n), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
