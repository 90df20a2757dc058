#!/usr/bin/env python
"""torch_mxflight: read the port's flight-recorder dumps from the
command line (the port's counterpart of ``tools/mxflight.py``).

A flight dump is the black box a process leaves behind when it dies (or
when ``mxnet_tpu_torch.telemetry.flight.dump()`` is called): the last N
engine, fault-injection, serve-scheduler and fleet-router events, with
monotonic sequence numbers and a wall-clock anchor.  Arm crash dumps
with ``MXNET_FLIGHT_DUMP=flight-{rank}.json``.

Resource-leak triage: ``show dump.json --kind res`` keeps the
``res.leak`` / ``res.double_free`` events the ``MXNET_RESCHECK=1``
sanitizer records — each names the handle kind, owner, scope and the
acquisition site, so a leak found by chaos CI is attributable without
re-running the job.

Subcommands:

  show    Pretty-print one or more dumps, newest last::

              python tools/torch_mxflight.py show flight-0.json --kind fleet --last 20

          ``--kind`` filters by exact event kind or dotted prefix
          (``engine`` matches ``engine.push``/``engine.flush``/...),
          ``--trace ID`` slices to one request's events (the ``tid``
          every serve/fleet event carries — a fleet trace id follows
          one request across router retries, hedges and the winning
          replica), ``--last N`` keeps the N most recent events per
          dump.

  merge   Merge multi-rank dumps into ONE chrome://tracing file on a
          correlated timeline (each dump's wall anchor aligns it, the
          same mechanism as ``tools/torch_mxtrace.py merge``)::

              python tools/torch_mxflight.py merge flight-0.json flight-1.json \\
                  -o merged.json --labels rank0 rank1

          Pass chrome traces too (``--with-trace worker0.json``) to
          overlay flight events onto their span timeline — flight
          events render as instants above the spans.
"""
from __future__ import annotations

import argparse
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)


def _fmt_event(e):
    extras = " ".join("%s=%s" % (k, v) for k, v in sorted(e.items())
                      if k not in ("seq", "ts", "kind"))
    return "%8d  %12.6f  %-20s %s" % (e.get("seq", -1), e.get("ts", 0.0),
                                      e.get("kind", "?"), extras)


def _cmd_show(args):
    from mxnet_tpu_torch.telemetry import flight

    for path in args.dumps:
        doc = flight.load(path)
        meta = doc.get("meta", {})
        evs = doc.get("events", [])
        if args.kind:
            evs = [e for e in evs
                   if e.get("kind") == args.kind
                   or str(e.get("kind", "")).startswith(args.kind + ".")]
        if args.trace:
            evs = [e for e in evs if str(e.get("tid", "")) == args.trace]
        if args.last is not None:
            evs = evs[-args.last:]
        print("== %s  (pid %s, rank %s, reason %r, %d/%d events, "
              "%d dropped)" % (path, meta.get("pid"), meta.get("rank"),
                               meta.get("reason"), len(evs),
                               meta.get("recorded", len(evs)),
                               meta.get("dropped", 0)))
        print("%8s  %12s  %-20s %s" % ("seq", "ts(s)", "kind", "fields"))
        for e in evs:
            print(_fmt_event(e))
    return 0


def _cmd_merge(args):
    from mxnet_tpu_torch.telemetry import flight, merge_traces

    inputs, labels = [], []
    for path in args.dumps:
        doc = flight.load(path)
        meta = doc.get("meta", {})
        inputs.append(flight.to_trace(doc))
        labels.append("flight:rank%s" % meta.get("rank", "?"))
    for path in args.with_trace or ():
        inputs.append(path)
        labels.append(os.path.basename(path))
    if args.labels:
        labels[:len(args.labels)] = args.labels
    merged = merge_traces(inputs, out=args.output, labels=labels)
    n = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
    print("merged %d events from %d input(s) -> %s"
          % (n, len(inputs), args.output))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_mxflight", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("show", help="pretty-print flight dumps")
    sp.add_argument("dumps", nargs="+", help="flight-recorder JSON dumps")
    sp.add_argument("--kind", default=None,
                    help="filter: exact kind or dotted prefix (fleet, "
                         "serve, engine, res)")
    sp.add_argument("--trace", default=None, metavar="ID",
                    help="keep only events stamped with this trace id "
                         "(serve/fleet 'tid' field)")
    sp.add_argument("--last", type=int, default=None,
                    help="keep only the N most recent events per dump")
    sp.set_defaults(fn=_cmd_show)

    mp = sub.add_parser("merge", help="merge dumps onto one timeline")
    mp.add_argument("dumps", nargs="+", help="flight-recorder JSON dumps")
    mp.add_argument("-o", "--output", default="merged_flight.json")
    mp.add_argument("--labels", nargs="*", default=None,
                    help="display name per input (default flight:rankN)")
    mp.add_argument("--with-trace", nargs="*", default=None,
                    help="profiler chrome-trace files to overlay")
    mp.set_defaults(fn=_cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
