#!/usr/bin/env python3
"""Time O7 (``csr_dot``, ``mxnet_tpu_torch/csrc/sparse_ops.cu``) against
an earlier build of it on one card, at the CTR cell's batch shape.

    python3 tools/torch_o7_compare.py --parent PATH/sparse_ops.cu
        [--iters 50] [--placements 0] [--out build/o7_compare.json]

Needs an NVIDIA card and nvcc.  The batches are ``chip_smoke.py``'s path
B shape, 8,192 rows of 22 nonzeros (1.0) out of 1,000,001 columns: the
first batch of its Zipf(1.3) ids (``chip_smoke.lc_ids`` from its seed,
the smoke's own first batch) and a batch of uniform ids
(``chip_smoke.o7_uniform_batch``).  For each batch, K 1 and 128 and both
modes, with seeded random rhs:

- both builds are checked against the plain version (within 1e-5 of the
  largest value);
- each call is timed as a caller pays for it, queued behind a sleep
  (``chip_smoke.queued_ms``): the change through ``csr_dot``; the parent
  through its own C interface, with the output allocated as its wrapper
  allocated it: an ``mxtt_csr_dot`` without the ``nnz`` argument adds
  into an output its caller zeroes (``torch.zeros``, transposed), one
  with it zeroes its output itself (``torch.empty``);
- in turns, parent, change, change, parent, so that the two compare on
  one card; each figure is the mean of its two turns.

With ``--placements P``, the transposed K 1 rows are also timed (in
turns) with the output at P further addresses: before each, one more
output-sized tensor is held, so that the next output takes a block the
allocator has not given before.  A scatter whose hot columns meet at
one L2 slice can depend on where the output lies.

Every number is the card's, with its name and power limit printed
first; the bound is ``chip_smoke.o7_bound``'s.
"""
import argparse
import ctypes
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parent_launcher(source):
    """``run(data, indptr, cols, rhs, shape, transpose_a)`` through the
    library built from ``source``, allocating its output as that
    source's wrapper did.  Its C interface is read from the source: with
    or without the ``nnz`` argument."""
    import torch

    from mxnet_tpu_torch.ops import _build

    path = os.path.abspath(source)
    with open(path) as f:
        takes_nnz = "long long nnz" in f.read()
    lib = ctypes.CDLL(_build.build(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mxtt_csr_dot.argtypes = [p] * 5 + [ll] * (4 if takes_nnz else 3) \
        + [i, p, ctypes.POINTER(i)]
    lib.mxtt_csr_dot.restype = i

    def run(data, indptr, cols, rhs, shape, transpose_a):
        m, n = shape
        kdim = rhs.shape[1]
        make = torch.zeros if transpose_a and not takes_nnz else torch.empty
        out = make((n if transpose_a else m, kdim), device=rhs.device)
        launched = ctypes.c_int(0)
        sizes = (m, n, kdim, data.shape[0]) if takes_nnz else (m, n, kdim)
        err = lib.mxtt_csr_dot(data.data_ptr(), indptr.data_ptr(),
                               cols.data_ptr(), rhs.data_ptr(),
                               out.data_ptr(), *sizes, int(transpose_a),
                               torch.cuda.current_stream().cuda_stream,
                               ctypes.byref(launched))
        if err:
            raise RuntimeError("the parent's csr_dot failed: %d" % err)
        return out
    return run


def main():
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops import sparse_ops as sops

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--placements", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_o7_compare: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi_line()
    print("card: %s" % smi, flush=True)
    dev = torch.device("cuda", 0)
    sops.build()
    parent = parent_launcher(args.parent)
    c = cs.LC
    m, shape = c["batch"], (c["batch"], c["features"])
    ids = cs.lc_ids(np.random.RandomState(cs.SPARSE_SEED), c)[:m]
    batches = {
        "zipf": (torch.ones(m * c["fields"], device=dev),
                 torch.arange(0, m * c["fields"] + 1, c["fields"],
                              device=dev),
                 torch.from_numpy(ids.reshape(-1)).to(dev)),
        "uniform": cs.o7_uniform_batch(dev, c, m, cs.SPARSE_SEED + 1)}
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SPARSE_SEED)
    q = cs.queued_ms
    rows = []
    print("%-8s %-10s %4s %10s %10s %10s %8s %8s" % (
        "batch", "mode", "K", "parent ms", "change ms", "bound ms",
        "speedup", "bound %"))
    for name, (data, indptr, cols) in batches.items():
        for kdim in (1, 128):
            for t in (False, True):
                rhs = torch.randn(m if t else shape[1], kdim, generator=g,
                                  device=dev)
                want = sops.csr_dot_ref(data, indptr, cols, rhs, shape, t)
                tol = cs.O7_TOL * max(float(want.abs().max()), 1.0)
                errs = [float((f(data, indptr, cols, rhs, shape, t)
                               - want).abs().max())
                        for f in (parent, sops.csr_dot)]
                del want
                if not max(errs) <= tol:
                    print("disagrees with the plain version: %s" % errs)
                    return 1

                def par(_):
                    parent(data, indptr, cols, rhs, shape, t)

                def chg(_):
                    sops.csr_dot(data, indptr, cols, rhs, shape, t)

                ts = [q(par, args.iters), q(chg, args.iters),
                      q(chg, args.iters), q(par, args.iters)]
                bound = cs.o7_bound(data, indptr, cols, shape, kdim, t)
                row = {"batch": name, "mode": "transposed" if t
                       else "forward", "k": kdim,
                       "parent_ms": (ts[0] + ts[3]) / 2,
                       "ms": (ts[1] + ts[2]) / 2, "turns_ms": ts,
                       "bound_ms": bound, "parent_err": errs[0],
                       "err": errs[1]}
                rows.append(row)
                print("%-8s %-10s %4d %10.4f %10.4f %10.4f %7.2fx %7.1f%%"
                      % (name, row["mode"], kdim, row["parent_ms"],
                         row["ms"], bound, row["parent_ms"] / row["ms"],
                         100 * bound / row["ms"]), flush=True)
                if t and kdim == 1 and args.placements:
                    held, row["placements"] = [], []
                    for _ in range(args.placements):
                        held.append(torch.empty(shape[1], 1, device=dev))
                        ts = [q(par, args.iters), q(chg, args.iters),
                              q(chg, args.iters), q(par, args.iters)]
                        row["placements"].append(
                            {"parent_ms": (ts[0] + ts[3]) / 2,
                             "ms": (ts[1] + ts[2]) / 2, "turns_ms": ts})
                    print("%-8s placements of the output: parent %s, "
                          "change %s" % (name, " ".join(
                              "%.4f" % p["parent_ms"]
                              for p in row["placements"]), " ".join(
                              "%.4f" % p["ms"] for p in row["placements"])),
                          flush=True)
                    del held
                del rhs
                torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
