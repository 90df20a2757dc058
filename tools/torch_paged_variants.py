#!/usr/bin/env python3
"""Build variants of the paged-attention kernel (K4) and time them.

    python3 tools/torch_paged_variants.py

Needs an NVIDIA card and nvcc.  Each variant is
``mxnet_tpu_torch/csrc/paged_attention.cu`` with its K/V ring depth
changed by text substitution (2, 3 or 4 stages) or its copies made
L1-allocating (``cp.async.ca``); all are compiled at once
(one nvcc each, with ``-Xptxas -v``) into ``build/variants/``.  For each
variant it prints ptxas's registers and spills for the decode
instantiation (f32 queries, bf16 pages, 4-row tiles), then, at the
Llama-3-8B decode shape of ``chip_smoke.kernel_timing`` (8 lanes at 1,024
tokens of context, 32/8 heads, D 128, bf16 pages, a 256-page table, four
page sets rotating), the device time of one call (queued behind a sleep,
``chip_smoke.queued_ms``; the combine included) with the context split
for about 0 (no split), 2, 3 and 4 blocks per SM, and the largest error
against the plain version.  The variants run in turns in one process, so
their times compare on one card.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAGES = "constexpr int kMaxStages = 2;"
COPY = "cp.async.cg.shared.global"
VARIANTS = {
    "as built (2 stages)": [],
    "3 stages": [(STAGES, STAGES.replace("2", "3"))],
    "4 stages": [(STAGES, STAGES.replace("2", "4"))],
    "2 stages, L1 copies": [(COPY, COPY.replace(".cg.", ".ca."))],
}
BLOCKS_PER_SM = (0, 2, 3, 4)
DECODE_KERNEL = "paged_attention_kernelIf13__nv_bfloat16Li4E"


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
                raise SystemExit("variant %r: %r not in the source"
                                 % (name, old))
            src = src.replace(old, new)
        cu = os.path.join(out_dir, "pa%d.cu" % i)
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, "pa%d.so" % i)
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
            if "Compiling entry" in line and DECODE_KERNEL in line:
                regs = re.search(r"Used (\d+) registers", lines[j + 3])
                spill = re.search(r"(\d+) bytes spill stores", lines[j + 2])
                print("%-24s decode kernel: %s registers, %s bytes spilled"
                      % (name, regs.group(1) if regs else "?",
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
    from mxnet_tpu_torch.ops import paged_attention as pa

    print(cs.nvidia_smi_line(), flush=True)
    libs = build_variants(_build, pa._SOURCE)
    dev = torch.device("cuda", 0)
    b, k1, h, kv, d, s_page = 8, 1, 32, 8, 128, 16
    ctx, maxp, pages, n_rot = 1024, 256, 2049, 4
    per_lane = ctx // s_page
    rng = np.random.default_rng(1)
    sets = []
    for _ in range(n_rot):
        perm = rng.permutation(np.arange(1, pages))[:b * per_lane]
        tables = [perm[i * per_lane:(i + 1) * per_lane].tolist()
                  for i in range(b)]
        sets.append(cs.make_case(rng, dev, b, k1, h, kv, d, s_page, pages,
                                 maxp, torch.float32, torch.bfloat16,
                                 [ctx - 1] * b, tables))
    want = [pa._paged_ref(*a, scale=d ** -0.5) for a in sets]
    sound = pa.SPLIT_BLOCKS_PER_SM
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            pa._bind(lib)
            _build._libs[pa._SOURCE] = lib
            for per_sm in BLOCKS_PER_SM:
                pa.SPLIT_BLOCKS_PER_SM = per_sm
                splits = pa.n_split(b, k1, h, kv, s_page, maxp,
                                    pa.sm_count(0))
                err = max((pa.paged_attention(*a) - w).abs().max().item()
                          for a, w in zip(sets, want))
                ms = cs.queued_ms(
                    lambda i: pa.paged_attention(*sets[i % n_rot]), 200)
                print("%-24s n_split %2d (%3d blocks): %.4f ms per call, "
                      "max_abs_err %.3g" % (name, splits, b * kv * splits,
                                            ms, err), flush=True)
    finally:
        pa.SPLIT_BLOCKS_PER_SM = sound
    return 0


if __name__ == "__main__":
    sys.exit(main())
