#!/usr/bin/env python
"""torch_mxfleet: run and operate a fleet of the port's serve replicas
from the CLI (the port's counterpart of ``tools/mxfleet.py``).

The fleet front (``mxnet_tpu_torch/serve/fleet.py``, docs/serving.md "Fleet
serving") routes over N ``LlamaServer`` replicas with queue-depth-aware
power-of-two-choices routing, bounded retries + opt-in hedging,
circuit-breaker ejection, and zero-dropped-request rolling deploys.

Subcommands:

  serve   Start N in-process replicas from one bundle behind a
          FleetRouter HTTP front (the one-process twin of running
          ``python -m mxnet_tpu_torch.serve`` N times behind a balancer)::

              python tools/torch_mxfleet.py serve --bundle llama.npz \\
                  --replicas 3 --port 8000

          Or front replicas that are already running elsewhere::

              python tools/torch_mxfleet.py serve --replica http://h1:8000 \\
                  --replica http://h2:8000 --port 9000

          Local replicas serve on ``cuda:0``.
          SIGTERM/Ctrl-C drains every local replica, then exits.

  status  One probe sweep over the replicas, printed as a table::

              python tools/torch_mxfleet.py status --replica http://h1:8000 \\
                  --replica http://h2:8000

          Columns: ok, draining, queue depth, TPOT p50, uptime,
          bundle_sha — a version-drift check across the fleet is one
          glance at the last column.

  top     Live fleet view off a running router front's ``/healthz``
          (docs/observability.md "Fleet observability")::

              python tools/torch_mxfleet.py top --router http://localhost:9000

          Redraws every ``--interval`` seconds (``--once`` prints a
          single frame and exits — the scriptable form): one row per
          replica with breaker state (ok / EJECTED / draining /
          deploying), queue depth, in-flight count, TPOT EMA, arena
          utilization and consecutive failures, under a fleet header
          with completed/retried/hedged/dropped totals and any burning
          SLOs.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO_ROOT)


def _replicas_from_args(args):
    from mxnet_tpu_torch.serve.fleet import HttpReplica

    return [HttpReplica(url) for url in args.replica or ()]


def _cmd_serve(args):
    from mxnet_tpu_torch.serve.fleet import FleetRouter
    from mxnet_tpu_torch.serve.server import LlamaServer

    replicas = _replicas_from_args(args)
    servers = []
    if args.bundle:
        for _ in range(args.replicas):
            servers.append(LlamaServer(
                args.bundle, queue_depth=args.queue_depth).start())
        replicas.extend(servers)
    if not replicas:
        print("nothing to serve: pass --bundle (local replicas) and/or "
              "--replica URL", file=sys.stderr)
        return 2
    router = FleetRouter(replicas).start()
    host, port = router.serve_http(port=args.port, host=args.host)
    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: term.set())
    print("serving fleet n=%d on http://%s:%d (%d local, %d remote)"
          % (len(replicas), host, port, len(servers),
             len(replicas) - len(servers)))
    try:
        term.wait()
    except KeyboardInterrupt:
        pass
    stragglers = 0
    for srv in servers:
        stragglers += srv.drain(timeout=args.drain_timeout)
    router.stop()
    for srv in servers:
        srv.stop()
    if stragglers:
        print("drain timed out: %d request(s) failed typed" % stragglers)
    return 0


def _cmd_status(args):
    from mxnet_tpu_torch.serve.fleet import HttpReplica

    rows = []
    for url in args.replica:
        r = HttpReplica(url)
        try:
            doc = r.probe()
        except Exception as e:  # noqa: BLE001 — a dead replica is a row
            rows.append((r.name, "DOWN", "-", "-", "-", "-",
                         "%s: %s" % (type(e).__name__, e)))
            continue
        rows.append((r.name,
                     "ok" if doc.get("ok") else "NOT-OK",
                     "yes" if doc.get("draining") else "no",
                     str(doc.get("queue_depth", "?")),
                     "%.4f" % doc.get("tpot_p50_s", 0.0),
                     "%.0fs" % doc.get("uptime_s", 0.0),
                     str(doc.get("bundle_sha"))))
    print("%-28s %-7s %-6s %-6s %-8s %-8s %s"
          % ("replica", "health", "drain", "queue", "tpot", "uptime",
             "bundle_sha"))
    for row in rows:
        print("%-28s %-7s %-6s %-6s %-8s %-8s %s" % row)
    shas = {row[6] for row in rows if row[1] == "ok"}
    if len(shas) > 1:
        print("WARNING: fleet has diverged across %d bundles: %s"
              % (len(shas), ", ".join(sorted(shas))))
        return 1
    return 0


def _replica_state(doc):
    if doc.get("ejected"):
        return "EJECTED"
    if doc.get("draining"):
        return "draining"
    if doc.get("deploying"):
        return "deploying"
    return "ok" if doc.get("ok") else "NOT-OK"


def _top_frame(body):
    slo = body.get("slo") or {}
    burning = slo.get("burning") or []
    lines = ["fleet: %d/%d healthy  completed=%s failed=%s retried=%s "
             "hedged=%s ejections=%s dropped=%s%s%s"
             % (body.get("replicas_healthy", 0),
                body.get("replicas_total", 0),
                body.get("completed", 0), body.get("failed", 0),
                body.get("retried", 0), body.get("hedged", 0),
                body.get("ejections", 0), body.get("dropped", 0),
                "  SHEDDING" if slo.get("shedding") else "",
                "  BURNING:" + ",".join(burning) if burning else "")]
    fmt = "%-28s %-10s %6s %9s %9s %7s %9s"
    lines.append(fmt % ("replica", "state", "queue", "inflight",
                        "tpot(s)", "arena", "failures"))
    for name in sorted(body.get("replicas", {})):
        doc = body["replicas"][name]
        lines.append(fmt % (
            name, _replica_state(doc),
            str(doc.get("queue_depth", "?")),
            str(doc.get("inflight", "?")),
            "%.4f" % float(doc.get("tpot_p50_s") or 0.0),
            "%3.0f%%" % (100.0 * float(doc.get("arena_utilization")
                                       or 0.0)),
            str(doc.get("failures", 0))))
    return "\n".join(lines)


def _cmd_top(args):
    import json
    import time
    import urllib.request

    url = args.router.rstrip("/") + "/healthz"
    while True:
        try:
            # the fleet front answers /healthz with 503 when nothing is
            # routable — that is still a frame worth rendering
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    body = json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                body = json.loads(e.read().decode())
        except Exception as e:  # noqa: BLE001 — a dead router is a frame
            body = None
            frame = "router %s unreachable: %s: %s" \
                % (args.router, type(e).__name__, e)
        if body is not None:
            frame = _top_frame(body)
        if args.once:
            print(frame)
            return 0 if body is not None and body.get("ok") else 1
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_mxfleet", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("serve", help="run a FleetRouter front")
    sp.add_argument("--bundle", default=None,
                    help="port serving bundle (.npz) for in-process "
                    "replicas")
    sp.add_argument("--replicas", type=int, default=3,
                    help="local replica count when --bundle is given")
    sp.add_argument("--replica", action="append", default=None,
                    metavar="URL", help="remote replica base URL "
                    "(repeatable)")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--queue-depth", type=int, default=None)
    sp.add_argument("--drain-timeout", type=float, default=None)
    sp.set_defaults(fn=_cmd_serve)

    st = sub.add_parser("status", help="probe replicas, print a table")
    st.add_argument("--replica", action="append", required=True,
                    metavar="URL", help="replica base URL (repeatable)")
    st.set_defaults(fn=_cmd_status)

    tp = sub.add_parser("top", help="live fleet view off a router front")
    tp.add_argument("--router", required=True, metavar="URL",
                    help="FleetRouter HTTP front base URL")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between redraws (default 2)")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clears)")
    tp.set_defaults(fn=_cmd_top)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
