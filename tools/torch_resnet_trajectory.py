#!/usr/bin/env python3
"""ResNet-50's train-loss trajectory on the smoke's fixed batch, several
ways in one process.

    python3 tools/torch_resnet_trajectory.py [steps]

Needs an NVIDIA card and nvcc.  ResNet-50 v1 under amp bf16, batch 256
at 224 x 224 (``chip_smoke``'s seeded images and random labels), sgd
with learning rate 0.1 and momentum 0.9 through ``JitTrainStep``, from
the same seeded weights each time, for ``steps`` steps (32 by default,
the smoke's count).  It prints the loss of every step for:

- the smoke's sequence: 11 eager steps, then the rest graphed;
- every step eager;
- every step eager, the update through the plain SGD version
  (``optimizer_ops._multi_sgd_ref``) instead of O2;
- every step graphed;
- twice every step eager with deterministic cuDNN algorithms,

then whether the first four are bitwise equal.  cuDNN autotunes
(``cudnn.benchmark``) except in the deterministic runs, as in the smoke;
TF32 is off.
"""
import gc
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def trajectory(dev, x, y, steps, graphed_from=None, plain=False,
               deterministic=False):
    """Losses of ``steps`` steps from fresh seeded weights: graphed from
    step ``graphed_from`` on (None: never), the update through the plain
    SGD version with ``plain``."""
    from mxnet_tpu_torch import amp, gluon, parallel
    from mxnet_tpu_torch.ops import optimizer_ops as oo

    torch.backends.cudnn.benchmark = not deterministic
    torch.backends.cudnn.deterministic = deterministic
    kernel = oo.multi_sgd
    if plain:
        oo.multi_sgd = oo._multi_sgd_ref
    gc.collect()
    torch.cuda.empty_cache()
    amp.init("bfloat16")
    try:
        net = cs.resnet_net(dev, "resnet50_v1", 0)
        amp.convert_hybrid_block(net)
        cs.resnet_shapes(net, x)
        step = parallel.JitTrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, graphs=False)
        losses = []
        for i in range(steps):
            step.graphs = graphed_from is not None and i >= graphed_from
            losses.append(step.step(x, y).item())
        return losses
    finally:
        amp.turn_off()
        oo.multi_sgd = kernel
        torch.backends.cudnn.deterministic = False


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("torch_resnet_trajectory.py needs an NVIDIA card")
    steps = int(argv[0]) if argv else 32
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    x, y = cs._resnet_batch(dev, cs.RESNET_BATCH, cs.RESNET_IMAGE, 0,
                            torch.bfloat16)
    runs = [("eager 11 steps, then graphed", dict(graphed_from=11)),
            ("eager", {}),
            ("eager, plain SGD update", dict(plain=True)),
            ("graphed", dict(graphed_from=0)),
            ("eager, deterministic cuDNN", dict(deterministic=True)),
            ("eager, deterministic cuDNN", dict(deterministic=True))]
    out = []
    for label, kw in runs:
        t0 = time.perf_counter()
        losses = trajectory(dev, x, y, steps, **kw)
        out.append(losses)
        print("%-30s %5.1f s  %s" % (label, time.perf_counter() - t0,
                                     " ".join("%.4f" % v for v in losses)),
              flush=True)
    same = all(o == out[0] for o in out[1:4])
    print("smoke sequence, eager, plain update and graphed bitwise equal: "
          "%s; the deterministic runs equal each other: %s"
          % (same, out[4] == out[5]))


if __name__ == "__main__":
    main(sys.argv[1:])
