#!/usr/bin/env python
"""torch_mxtrace: work with chrome traces and the port's flight dumps
from the command line (the port's counterpart of ``tools/mxtrace.py``).

Subcommands:

  merge   Merge per-process chrome-trace dumps (workers + servers) into
          ONE chrome://tracing file on a correlated timeline::

              python tools/torch_mxtrace.py merge worker0.json worker1.json \\
                  server.json -o merged.json --labels worker0 worker1 srv

          Timelines are aligned via the wall-clock anchor every dump
          carries (otherData.wall_t0_us); server handler spans keep
          their pid (= requesting rank + 1) while each input's local
          events get a fresh pid.  Load the result in chrome://tracing
          or https://ui.perfetto.dev — a worker's kv_push span sits
          directly over the server handler span it triggered (both
          carry the same args.span id).  See docs/observability.md.

          Flight-recorder dumps are accepted in place (auto-detected by
          their ``meta``/``events`` shape and converted via
          ``flight.to_trace``), so one command lines the fleet router's
          attempt spans up against each replica's serve timeline::

              python tools/torch_mxtrace.py merge router_flight.json \\
                  replica0_flight.json -o fleet.json --labels router r0

  summary Per-op aggregate table (count/total/avg/min/max us) from one
          or more trace files.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)


def _cmd_merge(args):
    from mxnet_tpu_torch.telemetry import flight, merge_traces

    inputs = []
    for path in args.traces:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "meta" in doc and "events" in doc:
            # a flight-recorder dump, not a chrome trace: convert it —
            # router fleet.attempt/fleet.request events become spans on
            # per-replica rows, so one `mxtrace merge router.json
            # replica0.json replica1.json` shows a hedged request
            # spanning two replicas next to each replica's own timeline
            inputs.append(flight.to_trace(flight.load(path)))
        else:
            inputs.append(path)
    merged = merge_traces(inputs, out=args.output, labels=args.labels)
    n = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
    print("merged %d events from %d trace(s) -> %s"
          % (n, len(args.traces), args.output))
    return 0


def _cmd_summary(args):
    stats = {}
    for path in args.traces:
        with open(path) as f:
            trace = json.load(f)
        events = trace.get("traceEvents", trace) \
            if isinstance(trace, dict) else trace
        for e in events:
            if e.get("ph") != "X":
                continue
            s = stats.setdefault(e["name"], {"count": 0, "total": 0.0,
                                             "min": float("inf"),
                                             "max": 0.0})
            s["count"] += 1
            s["total"] += e["dur"]
            s["min"] = min(s["min"], e["dur"])
            s["max"] = max(s["max"], e["dur"])
    rows = sorted(stats.items(), key=lambda kv: kv[1]["total"],
                  reverse=True)
    print("%-40s %8s %12s %12s %12s %12s"
          % ("Name", "Calls", "Total(us)", "Avg(us)", "Min(us)",
             "Max(us)"))
    for name, s in rows:
        print("%-40s %8d %12.1f %12.1f %12.1f %12.1f"
              % (name[:40], s["count"], s["total"],
                 s["total"] / s["count"], s["min"], s["max"]))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_mxtrace", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    mp = sub.add_parser("merge", help="merge per-process traces")
    mp.add_argument("traces", nargs="+", help="chrome-trace JSON files")
    mp.add_argument("-o", "--output", default="merged_trace.json")
    mp.add_argument("--labels", nargs="*", default=None,
                    help="display name per input (default worker<i>)")
    mp.set_defaults(fn=_cmd_merge)

    sp = sub.add_parser("summary", help="per-op aggregate table")
    sp.add_argument("traces", nargs="+")
    sp.set_defaults(fn=_cmd_summary)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
