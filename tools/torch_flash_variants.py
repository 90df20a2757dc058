#!/usr/bin/env python3
"""Build variants of the flash-attention kernels and time K1, K2 and K3.

    python3 tools/torch_flash_variants.py

Needs an NVIDIA card and nvcc.  Each variant is
``mxnet_tpu_torch/csrc/flash_attention.cu`` with one tile or ring size
changed by text substitution; all are compiled at once (one nvcc each,
with ``-Xptxas -v``) into ``build/variants/``.  For each variant it
prints ptxas's registers and spills for the six wgmma kernels, then K1's,
K2's and K3's device time at the Llama-3-8B train shape (B*H = 64,
T = 2048, D = 128, causal, bf16; CUDA events over 20 launches) and the
smoke's bf16 readings against the plain versions (each must be <= 1).
The variants run in turns in one process, so their times compare on one
card.  K2 with 128-key steps and 3 stages is left out: at D = 128 its
shared memory (Q, dO and 3 x 64 KB of K/V) passes the 227 KB a block may
have.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K1_STAGES = "static constexpr int BR = 128, BC = 128, kStages = HD == 128 ? 2 : 3;"
K3_TILES = "static constexpr int BK = 128, BQ = 64, kStages = 3, kPanels = HD / 64;"
K2_TILES = "static constexpr int BR = 128, BC = 128, kStages = 2, kPanels = HD / 64;"
VARIANTS = {
    "as built": [],
    "K2 steps of 64 keys, 2 stages": [(K2_TILES, K2_TILES.replace(
        "BC = 128", "BC = 64"))],
    "K2 steps of 64 keys, 3 stages": [(K2_TILES, K2_TILES.replace(
        "BC = 128, kStages = 2", "BC = 64, kStages = 3"))],
    "K1 3 stages at D 128": [(K1_STAGES, K1_STAGES.replace(
        "HD == 128 ? 2 : 3", "3"))],
    "K3 2 stages": [(K3_TILES, K3_TILES.replace("kStages = 3", "kStages = 2"))],
    "K3 steps of 32 queries, 4 stages": [(K3_TILES, K3_TILES.replace(
        "BQ = 64, kStages = 3", "BQ = 32, kStages = 4"))],
}


def build_variants(_build, source):
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = os.path.join(_build.cuda_home(), "bin", "nvcc")
    text = open(source).read()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit("variant %r: %r not in the source" % (name, old))
            src = src.replace(old, new)
        cu = os.path.join(out_dir, "v%d.cu" % i)
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, "v%d.so" % i)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-Xptxas", "-v",
             "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("variant %r failed to build:\n%s" % (name, log))
        lines = log.splitlines()
        for j, line in enumerate(lines):
            m = re.search(r"flash_\w+?wgmma_kernelILi\d+", line)
            if "Compiling entry" in line and m:
                regs = re.search(r"Used (\d+) registers", lines[j + 3])
                spill = re.search(r"(\d+) bytes spill stores", lines[j + 2])
                print("%-34s %-36s %s registers, %s bytes spilled"
                      % (name, m.group(0), regs.group(1) if regs else "?",
                         spill.group(1) if spill else "?"))
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa

    print(cs.nvidia_smi_line(), flush=True)
    libs = build_variants(_build, fa._SOURCE)
    dev = torch.device("cuda", 0)
    bh, t, d = 64, 2048, 128
    scale = d ** -0.5
    q, k, v, do = cs.flash_case(np.random.default_rng(3), dev, bh, t, t, d,
                                torch.bfloat16)
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fa._bind(lib)
        _build._libs[fa._SOURCE] = lib
        res = cs.flash_compare(fa, (q, k, v, do), scale, True)[0]
        out, lse = fa._fwd_kernel(q, k, v, scale, True)
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        k1 = cs.cuda_ms(lambda i: fa._fwd_kernel(q, k, v, scale, True), 20)
        k2 = cs.cuda_ms(lambda i: fa._run(
            "mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, lse, delta, dq,
            bh, t, t, d, scale, 1, 1), 20)
        k3 = cs.cuda_ms(lambda i: fa._run(
            "mxtt_flash_bwd_dkv", "dkv_launches", q, k, v, do, lse, delta,
            dk, dv, bh, t, t, d, scale, 1, 1), 20)
        print("%-34s K1 %.4f ms, K2 %.4f ms, K3 %.4f ms; readings %s"
              % (name, k1, k2, k3, " ".join("%s %.2f" % (n, r)
                                            for n, (r, _) in res.items())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
