"""Probe of fault F19: the two-thread bulked ``mx.nd`` steps of
``tests/test_torch_kernels_cuda.py::test_bulked_segments_bitwise_equal_eager_on_two_threads_on_card``
against the same steps eager, repeated, on the card.

Each repeat runs the test's ``work`` (four recorded steps of ``dot``,
``tanh``, ``mean``, a backward, then an unrecorded ``sum``) for seeds 1
and 2 in one mode, and compares ``loss``, ``w.grad`` and ``z`` of every
step bitwise with one eager run of the main thread:

* ``eager2``: two threads at once, each under ``engine.bulk(0)``;
* ``bulk1``: one fresh thread, bulked, the two seeds one after the other;
* ``bulk2``: two fresh threads at once, bulked (the test).

Every difference is printed with its mode, repeat, seed, step, array and
largest absolute difference; the last line is a JSON summary.  Run on
the card::

    python3 tools/torch_f19_probe.py --reps 30 --modes eager2,bulk1,bulk2
    python3 tools/torch_f19_probe.py --fresh 8     # 8 processes, one bulk2 each
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NAMES = ("loss", "grad", "z")


def work(mx, seed, out):
    rng = np.random.default_rng(seed)
    ctx = mx.gpu(0)
    w = mx.nd.array(rng.standard_normal((64, 64)).astype(np.float32), ctx=ctx)
    x = mx.nd.array(rng.standard_normal((32, 64)).astype(np.float32), ctx=ctx)
    w.attach_grad()
    res = []
    for _ in range(4):
        with mx.autograd.record():
            h = mx.nd.tanh(mx.nd.dot(x, w)) * 1.5 + 0.25
            loss = (h * h).mean()
        loss.backward()
        z = (w * 2.0 + 1.0).sum(axis=0)
        res.append((loss.asnumpy(), w.grad.asnumpy(), z.asnumpy()))
    out[seed] = res


def _threads(mx, targets):
    out = {}
    ts = [threading.Thread(target=t, args=(s, out)) for s, t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def run_mode(mx, mode):
    def eager(seed, out):
        with mx.engine.bulk(0):
            work(mx, seed, out)

    def bulked(seed, out):
        work(mx, seed, out)

    if mode == "eager2":
        return _threads(mx, [(1, eager), (2, eager)])
    if mode == "bulk2":
        return _threads(mx, [(1, bulked), (2, bulked)])
    if mode == "bulk1":
        out = {}

        def both(_, o):
            bulked(1, o)
            bulked(2, o)
        t = threading.Thread(target=both, args=(0, out))
        t.start()
        t.join()
        return out
    raise ValueError(mode)


def diffs(got, want):
    found = []
    for seed in (1, 2):
        for step, (a, b) in enumerate(zip(got[seed], want[seed])):
            for name, p, q in zip(NAMES, a, b):
                if not np.array_equal(p, q):
                    found.append((seed, step, name,
                                  float(np.max(np.abs(p - q)))))
    return found


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--modes", default="eager2,bulk1,bulk2")
    ap.add_argument("--fresh", type=int, default=0,
                    help="run this many fresh processes of one bulk2 each")
    args = ap.parse_args()
    if args.fresh:
        bad = 0
        for i in range(args.fresh):
            r = subprocess.run([sys.executable, __file__, "--reps", "1",
                                "--modes", "bulk2"], capture_output=True,
                               text=True)
            last = r.stdout.strip().splitlines()[-1] if r.stdout else "{}"
            got = json.loads(last).get("bulk2", {}).get("failed_reps", -1)
            bad += got != 0
            print("fresh %d: rc %d, failed reps %s" % (i, r.returncode, got))
            for line in r.stdout.splitlines()[:-1]:
                print("  " + line)
        print(json.dumps({"fresh": args.fresh, "fresh_failed": bad}))
        return
    import torch

    import mxnet_tpu_torch as mx

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    want = {}
    with mx.engine.bulk(0):
        for seed in (1, 2):
            work(mx, seed, want)
    summary = {}
    for mode in args.modes.split(","):
        failed = 0
        kinds = {}
        for rep in range(args.reps):
            found = diffs(run_mode(mx, mode), want)
            failed += bool(found)
            for seed, step, name, d in found:
                print("%s rep %d seed %d step %d %s differs by %.3g"
                      % (mode, rep, seed, step, name, d))
                kinds[name] = kinds.get(name, 0) + 1
        summary[mode] = {"reps": args.reps, "failed_reps": failed,
                         "arrays": kinds}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
