"""CLI: ``python -m mxnet_tpu_torch.serve --bundle llama.npz --port 8000``.

Loads the port's serving bundle (one ``.npz`` written by
``serve.save_serving_bundle``) onto ``--device`` (default ``cuda:0``;
``--device cpu`` serves on the host), starts the continuous-batching
loop, and exposes the stdlib HTTP front:
``POST /v1/generate {"prompt": [...ids], "max_new_tokens": n}``,
``POST /v1/chat`` (multi-turn, pinned sessions), ``GET /metrics``
(Prometheus), ``GET /healthz`` (scheduler stats).

``--fleet N`` (N > 1) starts N in-process replicas behind a
:class:`FleetRouter` front instead — queue-depth-aware routing, bounded
retries, circuit-breaker ejection — on the same HTTP surface
(``tools/torch_mxfleet.py`` is the richer fleet CLI: remote replicas,
status, rolling deploys).  On one card the replicas share it, each with
its own weights and arena.

SIGTERM (what an orchestrator sends on pod eviction / rollout) triggers
the graceful path: stop admission (503 + Retry-After), finish in-flight
work within ``--drain-timeout`` (default ``MXNET_SERVE_DRAIN_TIMEOUT``),
fail stragglers typed, then exit.  Ctrl-C takes the same path.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading

from .fleet import FleetRouter
from .server import LlamaServer


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mxnet_tpu_torch.serve")
    ap.add_argument("--bundle", required=True,
                    help="port serving bundle, .npz (save_serving_bundle)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device the replicas serve on (default "
                         "cuda:0; cpu for a host run)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--fleet", type=int, default=1, metavar="N",
                    help="serve N in-process replicas behind a "
                         "FleetRouter front (default 1: plain server)")
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=None,
                    help="runtime speculative draft count (default: the "
                         "bundle's spec_k; 0 disables)")
    ap.add_argument("--kv-dtype", default=None,
                    help="assert the bundle's KV arena dtype (e.g. int8) "
                         "— refuses to serve on mismatch")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    help="seconds to let in-flight work finish on "
                         "SIGTERM/Ctrl-C (default: "
                         "MXNET_SERVE_DRAIN_TIMEOUT or 30)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request KV prefix sharing "
                         "(sets MXNET_SERVE_PREFIX_CACHE=0)")
    ap.add_argument("--session-ttl", type=float, default=None,
                    help="idle seconds before a pinned /v1/chat session "
                         "is evicted (default: MXNET_SERVE_SESSION_TTL "
                         "or 600)")
    args = ap.parse_args(argv)
    if args.no_prefix_cache:
        os.environ["MXNET_SERVE_PREFIX_CACHE"] = "0"
    if args.session_ttl is not None:
        os.environ["MXNET_SERVE_SESSION_TTL"] = str(args.session_ttl)
    if args.fleet < 1:
        ap.error("--fleet must be >= 1")

    def _make_server():
        return LlamaServer(args.bundle, queue_depth=args.queue_depth,
                           spec_k=args.spec_k, kv_dtype=args.kv_dtype,
                           device=args.device).start()

    term = threading.Event()
    if args.fleet == 1:
        srv = _make_server()
        host, port = srv.serve_http(port=args.port, host=args.host)
        # registered before the banner: the orchestrator (or a test) may
        # SIGTERM the moment it sees the port
        signal.signal(signal.SIGTERM, lambda *a: term.set())
        print("serving %s on http://%s:%d  [%s]"
              % (args.bundle, host, port, srv.geometry.describe()),
              flush=True)
        try:
            term.wait()
        except KeyboardInterrupt:
            pass
        stragglers = srv.drain(timeout=args.drain_timeout)
        srv.stop()
        if stragglers:
            print("drain timed out: %d request(s) failed typed"
                  % stragglers)
        return

    servers = [_make_server() for _ in range(args.fleet)]
    router = FleetRouter(servers).start()
    host, port = router.serve_http(port=args.port, host=args.host)
    signal.signal(signal.SIGTERM, lambda *a: term.set())
    print("serving fleet n=%d %s on http://%s:%d  [%s]"
          % (args.fleet, args.bundle, host, port,
             servers[0].geometry.describe()), flush=True)
    try:
        term.wait()
    except KeyboardInterrupt:
        pass
    stragglers = 0
    for srv in servers:  # drain one at a time: the router steers away
        stragglers += srv.drain(timeout=args.drain_timeout)
    router.stop()
    for srv in servers:
        srv.stop()
    if stragglers:
        print("drain timed out: %d request(s) failed typed" % stragglers)


if __name__ == "__main__":
    main()
