"""FleetRouter: a queue-aware HTTP front over N LlamaServer replicas.

The port's copy of the JAX package's fleet tier: the router is host
code, and each replica is the port's ``LlamaServer`` over a
``TorchRunner`` (on one card, replicas in one process share it).

One `LlamaServer` is one failure domain: a loop crash, a slow decode
pace, or a bundle deploy takes every request with it.  This module makes
the *fleet* strictly more robust than any one replica with four pillars,
all built on the per-replica primitives of the server (drain +
Retry-After, ``reload()`` hot-swap, sticky not-ok ``/healthz``,
``DELETE /v1/generate/<id>`` cancellation):

* **Queue-depth-aware routing.**  A background prober polls every
  replica's ``/healthz`` (interval ``MXNET_FLEET_PROBE_INTERVAL``) and
  feeds a power-of-two-choices picker: sample two candidates, score each
  by ``(queue_depth + router in-flight) x TPOT pace``, route to the
  lower.  Two random choices beat both round-robin (ignores load) and
  global-minimum (herds onto one replica between probes).  A replica's
  ``Retry-After`` hint gates it out of the candidate set until the hint
  expires.  ``submit(session=...)`` carries a chat-session
  affinity hint: the turn prefers the replica whose arena pins the
  session's pages (routing it anywhere else guarantees a
  ``ServeSessionUnknown``), falling back to p2c when that replica is
  ejected, draining, or gated.

* **Bounded retries + hedging.**  Submit-time refusals (queue full,
  draining, dead loop, connection errors) retry on a *different*
  replica with exponential backoff — ``base * 2^k`` capped at
  5 s, +-25 % jitter (``MXNET_FLEET_RETRIES``/``MXNET_FLEET_BACKOFF``).
  Mid-flight failures retry only for idempotent requests (greedy
  generation is; a sampled request replayed elsewhere is a different
  request).  Opt-in hedging (``MXNET_FLEET_HEDGE``) fires a second
  attempt on another replica after a p99-derived delay; the first
  winner cancels the loser via the replica's cancellation surface.  The
  client deadline is *decremented* across attempts and propagated, so a
  retry can never resurrect an expired request.

* **Replica lifecycle.**  ``MXNET_FLEET_EJECT_AFTER`` consecutive bad
  probes (exception, or a sticky not-ok body) eject a replica — a
  per-replica circuit breaker.  After ``MXNET_FLEET_READMIT_AFTER``
  seconds the breaker goes half-open: one probe is allowed through, and
  a healthy answer re-admits the replica.  ``rolling_deploy(bundle)``
  walks the fleet one replica at a time — steer traffic away, drain +
  ``reload()`` at a step boundary (the server's zero-dropped-requests swap),
  re-probe, re-admit — and raises unless every replica converged to the
  same ``bundle_sha`` (the ``/healthz`` field added for exactly this).

* **Chaos verification.**  Five injection sites
  (``fleet_probe``/``fleet_forward`` on the router side,
  ``replica_kill``/``replica_hang``/``replica_slow`` on the forward
  path into a replica) drive the seeded deterministic matrix in
  ``tests/test_torch_fleet.py`` — run twice per seed, asserting
  identical outcomes, every non-doomed request completed typed, and
  leak-free arenas on every replica.

Telemetry: ``mxnet_fleet_requests_total{replica,status}``,
``mxnet_fleet_retries_total{reason}``,
``mxnet_fleet_hedges_total{outcome}``,
``mxnet_fleet_ejections_total{replica,reason}``,
``mxnet_fleet_replicas_healthy``, ``mxnet_fleet_route_queue_depth``,
plus ``fleet.*`` flight events (retry/hedge/eject/readmit/deploy).

The fleet observability plane (docs/observability.md "Fleet
observability") rides on three seams here:

* **Distributed tracing.**  ``submit()`` mints a fleet trace id
  (``f<pid>-<n>``) that replicas stamp into ``Request.trace_id``
  (in-process) or receive via an ``X-MXNet-Trace`` header (HTTP), so
  one id correlates router and replica flight events.  Every attempt —
  retry, hedge, cancellation-of-loser — records an attributed
  ``fleet.attempt``/``fleet.hedge``/``fleet.cancel`` event (attempt
  index, replica, role, duration), and ``GET /v1/trace/<id>`` prepends
  the routing breakdown to the owning replica's stored trace.
* **Metric aggregation.**  The prober scrapes each replica's metrics
  every ``MXNET_FLEET_METRICS_EVERY``-th probe;
  ``fleet_metrics_snapshot()`` merges them via
  ``telemetry.aggregate`` (counters sum, gauges keep per-replica
  series, histograms merge bucket-wise) and the fleet ``GET /metrics``
  serves the merged exposition.
* **SLO engine.**  ``attach_slo()`` (or ``MXNET_FLEET_SLO``) evaluates
  declarative objectives over the aggregated stream each probe sweep;
  with ``MXNET_FLEET_SLO_SHED`` the fast-window burn alert sheds
  optional work — hedging turns off until the alert clears.

Replicas can be in-process ``LlamaServer`` objects (the chaos tests
run 3 in one process) or ``http://host:port`` bases fronting
remote servers; both hide behind the same probe/submit/cancel surface.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

from ..base import MXNetError, env_flag
from ..telemetry import aggregate as _aggregate
from ..telemetry import flight as _flight
from ..telemetry import metrics as _metrics
from ..telemetry import slo as _slo
from ..testing import faults as _faults
from ..testing import lockcheck as _lockcheck
from ..testing import rescheck as _rescheck
from .scheduler import (Request, ServeCancelled, ServeDeadlineExceeded,
                        ServeDraining, ServeInternalError, ServeQueueFull,
                        ServeSessionBusy, ServeSessionUnknown, ServeShutdown,
                        _env_float, _env_int, clamp_retry_after)

__all__ = [
    "FleetRouter", "FleetNoHealthyReplica", "LocalReplica", "HttpReplica",
    "fleet_drive_workload",
]

_BACKOFF_CAP_S = 5.0      # same ceiling as the kvstore retry discipline
_ROUTE_DEPTH_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


class FleetNoHealthyReplica(MXNetError):
    """Every replica is ejected, draining, or gated by a Retry-After
    hint.  Carries ``retry_after_s`` so the HTTP front can tell the
    caller when trying again is worthwhile."""

    retry_after_s = 1.0


# ---------------------------------------------------------------------------
# replica adapters: one probe/submit/cancel/reload surface, two transports
# ---------------------------------------------------------------------------

class _LocalHandle:
    """An in-flight request on an in-process replica (wraps the
    scheduler's ``Request`` future)."""

    def __init__(self, replica, req):
        self._replica = replica
        self.req = req

    @property
    def trace_id(self):
        return self.req.trace_id

    @property
    def error(self):
        return self.req.error

    @property
    def ttft(self):
        return self.req.ttft

    def wait(self, timeout):
        return self.req._done.wait(timeout)

    def done(self):
        return self.req.done()

    def result(self, timeout):
        return self.req.result(timeout)

    def cancel(self):
        return self._replica.cancel(self.req.trace_id)


class _HungHandle:
    """The deterministic stand-in for a replica that accepted a request
    and then went silent (``replica_hang``): never completes, cancel is
    a no-op — the hedge path's reason to exist."""

    trace_id = None
    error = None
    ttft = None

    def __init__(self, replica_name):
        self._replica_name = replica_name
        self._never = threading.Event()

    def wait(self, timeout):
        return self._never.wait(timeout)

    def done(self):
        return False

    def result(self, timeout):
        self._never.wait(timeout)
        raise ServeInternalError(
            "request hung on replica %s (fault-injected) and no hedge "
            "completed it" % self._replica_name)

    def cancel(self):
        return True


class LocalReplica:
    """An in-process ``LlamaServer`` behind the replica surface.

    ``reload_fn`` is the chaos seam: ``from_parts`` servers have no
    bundle file to load, so the fleet-chaos matrix substitutes a
    scripted hot-swap (same ``_pending_swap`` machinery, no disk)."""

    def __init__(self, server, name=None, reload_fn=None):
        self.server = server
        self.name = name or getattr(server, "server_id", None) or \
            "r%x" % id(server)
        self._reload_fn = reload_fn

    def probe(self):
        return self.server.healthz()

    def metrics(self):
        """Per-replica metrics scrape.  In-process replicas share ONE
        registry, so scraping it per replica would multiply every count
        by N — the per-server scheduler aggregates are the only honest
        per-replica numbers here (``aggregate.snapshot_from_stats``)."""
        return _aggregate.snapshot_from_stats(self.server.stats())

    def trace(self, trace_id):
        return self.server.scheduler.trace(trace_id)

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_s=None, session=None, trace_id=None):
        _faults.maybe_inject("replica_slow", replica=self.name)
        try:
            _faults.maybe_inject("replica_kill", replica=self.name)
        except _faults.LoopKilled as e:
            # the replica "process" dies: in-flight work fails typed via
            # the loop-crash containment path, healthz flips sticky
            # not-ok, and the router sees a dead transport
            self.server._contain_loop_failure(e)
            raise ConnectionResetError(
                "replica %s died (%s)" % (self.name, e))
        try:
            _faults.maybe_inject("replica_hang", replica=self.name)
        except _faults.FaultInjected:
            return _HungHandle(self.name)
        req = self.server.scheduler.submit(
            Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    deadline_s=deadline_s, session_id=session,
                    trace_id=trace_id))
        return _LocalHandle(self, req)

    def cancel(self, trace_id):
        if trace_id is None:
            return False
        return self.server.scheduler.cancel(trace_id)

    def reload(self, bundle_path, timeout=60):
        if self._reload_fn is not None:
            return self._reload_fn(bundle_path, timeout)
        return self.server.reload(bundle_path, timeout=timeout)


class _HttpHandle:
    """An in-flight request on a remote replica: one daemon thread owns
    the blocking POST; the handle mirrors the Request-future surface."""

    def __init__(self, replica, doc, timeout, path="/v1/generate",
                 fleet_trace_id=None):
        self._replica = replica
        self._path = path
        # the fleet trace id is addressable for cancellation even before
        # the response echoes one back (hedging cancels losers mid-POST)
        self.trace_id = fleet_trace_id
        self._fleet_trace_id = fleet_trace_id
        self.error = None
        self.ttft = None
        self.tokens = None
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(doc, timeout),
            name="mxnet-fleet-http", daemon=True)
        self._thread.start()

    def _run(self, doc, timeout):
        try:
            body = json.dumps(doc).encode()
            headers = {"Content-Type": "application/json"}
            if self._fleet_trace_id:
                headers["X-MXNet-Trace"] = self._fleet_trace_id
            req = urllib.request.Request(
                self._replica.base_url + self._path, data=body,
                headers=headers)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out = json.loads(resp.read())
            self.tokens = out["tokens"]
            self.trace_id = out.get("trace_id") or self._fleet_trace_id
            self.ttft = out.get("ttft_s")
        except urllib.error.HTTPError as e:
            self.error = _error_from_http(e)
        except Exception as e:  # noqa: BLE001 — transport errors surface typed
            self.error = e
        finally:
            self._done.set()

    def wait(self, timeout):
        return self._done.wait(timeout)

    def done(self):
        return self._done.is_set()

    def result(self, timeout):
        if not self._done.wait(timeout):
            raise MXNetError("request timed out after %ss (replica %s)"
                             % (timeout, self._replica.name))
        if self.error is not None:
            raise self.error
        return self.tokens

    def cancel(self):
        return self._replica.cancel(self.trace_id)


def _error_from_http(e):
    """Map an HTTP error from a replica back onto the typed serve
    errors so the router's retry classification is transport-agnostic."""
    try:
        detail = json.loads(e.read()).get("error", "")
    except Exception:  # noqa: BLE001 — diagnostics only
        detail = ""
    msg = "%s (HTTP %d)" % (detail or e.reason, e.code)
    if e.code == 504:
        return ServeDeadlineExceeded(msg)
    if e.code == 404 and "session" in detail:
        return ServeSessionUnknown(msg)
    if e.code == 409:
        return ServeSessionBusy(msg) if "session" in detail \
            else ServeCancelled(msg)
    if e.code == 503:
        err = ServeDraining(msg) if "draining" in detail \
            else ServeQueueFull(msg)
        try:
            err.retry_after_s = clamp_retry_after(
                float(e.headers.get("Retry-After", 1)))
        except (TypeError, ValueError):
            pass
        return err
    return MXNetError(msg)


class HttpReplica:
    """A remote ``LlamaServer`` HTTP front behind the replica surface."""

    def __init__(self, base_url, name=None, probe_timeout=2.0):
        self.base_url = base_url.rstrip("/")
        self.name = name or self.base_url.split("//", 1)[-1]
        self._probe_timeout = probe_timeout

    def probe(self):
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=self._probe_timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            # 503 still carries the healthz body (ok=False / draining)
            return json.loads(e.read())

    def metrics(self):
        """Scrape the replica's full registry snapshot
        (``GET /metrics.json``) — a remote replica is its own process,
        so the whole registry is honestly per-replica."""
        with urllib.request.urlopen(self.base_url + "/metrics.json",
                                    timeout=self._probe_timeout) as r:
            return json.loads(r.read())

    def trace(self, trace_id):
        """The replica's stored per-request trace; None when unknown."""
        try:
            with urllib.request.urlopen(
                    self.base_url + "/v1/trace/" + trace_id,
                    timeout=self._probe_timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError:
            return None

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_s=None, session=None, trace_id=None):
        doc = {"prompt": prompt, "max_new_tokens": max_new_tokens,
               "eos_id": eos_id, "deadline_s": deadline_s}
        if session is not None:
            doc["session"] = session
            return _HttpHandle(self, doc, timeout=300, path="/v1/chat",
                               fleet_trace_id=trace_id)
        return _HttpHandle(self, doc, timeout=300, fleet_trace_id=trace_id)

    def cancel(self, trace_id):
        if trace_id is None:
            return False  # response never arrived: nothing addressable
        # a urllib.request.Request, not a serve future  # mxlint: disable=RL1203
        req = urllib.request.Request(
            self.base_url + "/v1/generate/" + trace_id, method="DELETE")
        try:
            with urllib.request.urlopen(req, timeout=self._probe_timeout):
                return True
        except (urllib.error.URLError, OSError):
            return False

    def reload(self, bundle_path, timeout=60):
        raise MXNetError(
            "HTTP replica %s exposes no reload surface — deploy it from "
            "its own process (mxnet_tpu_torch.serve --bundle ... or "
            "torch_mxfleet)"
            % self.name)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class _ReplicaState:
    """Router-side view of one replica (guarded by the router lock)."""

    __slots__ = ("ok", "draining", "deploying", "ejected", "failures",
                 "queue_depth", "tpot", "inflight", "not_before_route",
                 "half_open_at", "bundle_sha", "last_error", "probes",
                 "arena_util", "metrics_snap", "metrics_t")

    def __init__(self):
        self.ok = True            # optimistic until the first probe
        self.draining = False
        self.deploying = False
        self.ejected = False
        self.failures = 0         # consecutive bad probes/transports
        self.queue_depth = 0
        self.tpot = 0.0
        self.inflight = 0         # router-side, reacts faster than probes
        self.not_before_route = 0.0   # Retry-After gate
        self.half_open_at = 0.0       # breaker re-probe time
        self.bundle_sha = None
        self.last_error = None
        self.probes = 0
        self.arena_util = 0.0
        self.metrics_snap = None  # last /metrics scrape (lower cadence)
        self.metrics_t = 0.0


class _FleetFuture:
    """``FleetRouter.submit``'s return.

    The first route+submit happens EAGERLY on the submitter's thread —
    sub-millisecond, and the request is in a replica's queue before
    ``submit()`` returns, so decoding starts with no thread hop (a
    per-request waiter thread measured as an 11% throughput tax at
    N=1).  The retry/hedge state machine runs lazily inside
    ``result()`` on the waiter's thread, resolved exactly once."""

    def __init__(self, router, kwargs):
        self._router = router
        self._kwargs = kwargs
        self.tokens = None
        self.error = None
        self.replica = None
        self.ttft = None
        self.trace_id = kwargs.get("trace_id")
        self._lock = threading.Lock()
        self._resolved = False
        self._res = _rescheck.acquire("future", "fleet-req",
                                      scope=router.res_scope)
        deadline_s = kwargs.get("deadline_s")
        self._t0 = router._clock()
        self._deadline_t = None if deadline_s is None \
            else self._t0 + deadline_s
        self._first = router._eager_submit(kwargs, self._deadline_t)

    def done(self):
        if self._resolved:
            return True
        first = self._first
        return (first is not None and first[1] is not None
                and first[1].done())

    def result(self, timeout=300):
        with self._lock:
            if not self._resolved:
                kw = dict(self._kwargs)
                kw["timeout"] = min(timeout, kw.get("timeout", timeout))
                first, self._first = self._first, None
                try:
                    self.tokens = self._router._generate(
                        self, _first=first, _deadline_t=self._deadline_t,
                        _t0=self._t0, **kw)
                except MXNetError as e:
                    self.error = e
                except Exception as e:  # noqa: BLE001 — must resolve typed
                    self.error = MXNetError(
                        "fleet request failed: %s: %s"
                        % (type(e).__name__, e))
                finally:
                    self._resolved = True
                    _rescheck.release(self._res)
                    self._res = None
        if self.error is not None:
            raise self.error
        return self.tokens


class FleetRouter:
    """Routes requests over N replicas; see the module docstring."""

    def __init__(self, replicas, probe_interval=None, retries=None,
                 backoff_s=None, hedge=None, hedge_delay_s=None,
                 eject_after=None, readmit_after_s=None, seed=0,
                 clock=time.monotonic, sleep=time.sleep):
        self._replicas = [self._wrap(r, i) for i, r in enumerate(replicas)]
        if not self._replicas:
            raise MXNetError("FleetRouter needs at least one replica")
        names = [r.name for r in self._replicas]
        if len(set(names)) != len(names):
            raise MXNetError("duplicate replica names: %r" % (names,))
        self._states = {r.name: _ReplicaState() for r in self._replicas}
        self.probe_interval = probe_interval if probe_interval is not None \
            else _env_float("MXNET_FLEET_PROBE_INTERVAL", 0.5)
        self.retries = retries if retries is not None \
            else _env_int("MXNET_FLEET_RETRIES", 2)
        self.backoff_s = backoff_s if backoff_s is not None \
            else _env_float("MXNET_FLEET_BACKOFF", 0.05)
        self.hedge = hedge if hedge is not None \
            else env_flag("MXNET_FLEET_HEDGE", False)
        self.hedge_delay_s = hedge_delay_s if hedge_delay_s is not None \
            else _env_float("MXNET_FLEET_HEDGE_DELAY", 0.0)
        self.eject_after = eject_after if eject_after is not None \
            else _env_int("MXNET_FLEET_EJECT_AFTER", 3)
        self.readmit_after_s = readmit_after_s if readmit_after_s is not None \
            else _env_float("MXNET_FLEET_READMIT_AFTER", 2.0)
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = _lockcheck.named_lock("fleet.router")
        self._lat = collections.deque(maxlen=512)  # ok latencies (hedge p99)
        # session -> replica-name affinity (bounded LRU): a pinned chat
        # session's pages live on ONE replica, so routing its next turn
        # anywhere else is a guaranteed ServeSessionUnknown
        self._affinity = collections.OrderedDict()
        self._affinity_cap = _env_int("MXNET_FLEET_AFFINITY_CAP", 4096)
        self._stop = threading.Event()
        self._poll_thread = None
        self._res_thread = None
        self._http = None
        self.res_scope = "fleet:%x" % id(self)
        # fleet-wide counters (mirrored into telemetry per event)
        self.completed = 0
        self.failed = 0
        self.retried = 0
        self.hedged = 0
        self.ejections = 0
        self.dropped = 0   # requests failed by a drain sweep (shutdown)
        # observability plane: trace store, metrics-scrape
        # cadence, optional SLO engine + shed state
        self.metrics_every = max(1, _env_int("MXNET_FLEET_METRICS_EVERY",
                                             4))
        self._trace_ids = itertools.count()
        self._trace_cap = _env_int("MXNET_FLEET_TRACE_CAP", 512)
        self._rtraces = collections.OrderedDict()
        self._slo = None
        self._shedding = False
        self._hedge_saved = None

    @staticmethod
    def _wrap(replica, index):
        if isinstance(replica, (LocalReplica, HttpReplica)):
            return replica
        if isinstance(replica, str):
            return HttpReplica(replica, name="r%d" % index)
        return LocalReplica(replica, name="r%d" % index)

    # -- lifecycle --------------------------------------------------------
    def start(self, poller=True):
        """Probe every replica once (routing needs state before the
        first request), then start the background prober — unless the
        caller drives ``probe_all()`` itself (the chaos matrix does,
        for determinism)."""
        spec = os.environ.get("MXNET_FLEET_SLO")
        if spec and self._slo is None:
            objectives = _slo.parse_objectives(spec)
            if objectives:
                self.attach_slo(_slo.SLOEngine(objectives=objectives,
                                               clock=self._clock))
        self.probe_all()
        if poller and self.probe_interval > 0 and self._poll_thread is None:
            self._stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="mxnet-fleet-probe",
                daemon=True)
            self._poll_thread.start()
            self._res_thread = _rescheck.acquire(
                "thread", "mxnet-fleet-probe", scope=self.res_scope)
        return self

    def _poll_loop(self):
        while not self._stop.wait(self.probe_interval):
            self.probe_all()

    def stop(self):
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None
            _rescheck.release(self._res_thread)
            self._res_thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http = None
        if _rescheck.enabled():
            _rescheck.assert_quiescent(scope=self.res_scope)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- probing + circuit breaker ---------------------------------------
    def probe_all(self, metrics=False):
        """One probe sweep.  ``metrics=True`` forces the lower-cadence
        metrics scrape on every replica this sweep (tests and the fleet
        ``/metrics`` endpoint's first serve use it)."""
        for r in self._replicas:
            self._probe_one(r, force_metrics=metrics)
        self._update_healthy_gauge()
        self._slo_tick()

    def _probe_one(self, replica, force_metrics=False):
        now = self._clock()
        with self._lock:
            st = self._states[replica.name]
            if st.ejected and now < st.half_open_at:
                return  # breaker open: not yet time for the half-open probe
        try:
            _faults.maybe_inject("fleet_probe", replica=replica.name)
            doc = replica.probe()
        except Exception as e:  # noqa: BLE001 — a probe must never raise
            with self._lock:
                st.probes += 1
                st.failures += 1
                st.ok = False
                st.last_error = "%s: %s" % (type(e).__name__, e)
            self._maybe_eject(replica, "probe_failure")
            return
        with self._lock:
            st.probes += 1
            st.queue_depth = int(doc.get("queue_depth", 0))
            st.tpot = float(doc.get("tpot_p50_s") or 0.0)
            st.arena_util = float(doc.get("arena_utilization") or 0.0)
            st.draining = bool(doc.get("draining", False))
            st.bundle_sha = doc.get("bundle_sha")
            ok = bool(doc.get("ok", False))
            st.ok = ok
            if ok:
                st.failures = 0
                st.last_error = None
                readmitted = st.ejected
                st.ejected = False
            elif st.draining:
                # draining is deliberate (deploy/shutdown), not a fault:
                # steer away, don't trip the breaker
                readmitted = False
            else:
                st.failures += 1
                st.last_error = doc.get("last_loop_error")
                readmitted = False
            draining = st.draining
            # metrics ride the healthz prober at 1/Nth cadence: a scrape
            # is heavier than a probe (full registry vs one doc), and
            # gauges staler than a few probe intervals still aggregate
            scrape = ok and (force_metrics or st.metrics_snap is None
                             or st.probes % self.metrics_every == 0)
        if readmitted:
            _flight.record("fleet.readmit", replica=replica.name)
        if scrape:
            self._scrape_metrics(replica)
        if ok and not draining:
            return
        self._maybe_eject(replica, "unhealthy")

    def _scrape_metrics(self, replica):
        try:
            snap = replica.metrics()
        except Exception as e:  # noqa: BLE001 — scrape must never kill probe
            _flight.record("fleet.scrape_error", replica=replica.name,
                           error="%s: %s" % (type(e).__name__, e))
            return
        with self._lock:
            st = self._states[replica.name]
            st.metrics_snap = snap
            st.metrics_t = self._clock()

    def _slo_tick(self):
        if self._slo is None:
            return
        try:
            self._slo.observe(self.fleet_metrics_snapshot(),
                              now=self._clock())
        except Exception as e:  # noqa: BLE001 — the prober must survive
            _flight.record("slo.error",
                           error="%s: %s" % (type(e).__name__, e))

    def _maybe_eject(self, replica, reason):
        with self._lock:
            st = self._states[replica.name]
            if st.ejected or st.failures < self.eject_after:
                if st.ejected:  # half-open probe failed: re-arm the timer
                    st.half_open_at = self._clock() + self.readmit_after_s
                return
            st.ejected = True
            st.half_open_at = self._clock() + self.readmit_after_s
            self.ejections += 1
            failures = st.failures
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_fleet_ejections_total",
                help="replicas ejected by the fleet circuit breaker",
                replica=replica.name, reason=reason).inc()
        _flight.record("fleet.eject", replica=replica.name, reason=reason,
                       failures=failures)
        self._update_healthy_gauge()

    def _update_healthy_gauge(self):
        if not _metrics.enabled():
            return
        with self._lock:
            n = sum(1 for st in self._states.values()
                    if not st.ejected and st.ok and not st.draining
                    and not st.deploying)
        _metrics.gauge(
            "mxnet_fleet_replicas_healthy",
            help="replicas currently routable (not ejected/draining)"
        ).set(n)

    # -- fleet metric aggregation -----------------------------------------
    def fleet_metrics_snapshot(self):
        """The fleet-wide merged snapshot: per-replica scrapes merged
        with aggregate semantics (counters sum, gauges per-replica,
        histograms bucket-wise), overlaid with the router's own
        registry for families no scrape carries (``mxnet_fleet_*``,
        ``mxnet_slo_*``, and — in-process — the shared histograms)."""
        missing = []
        with self._lock:
            snaps = {}
            now = self._clock()
            for r in self._replicas:
                st = self._states[r.name]
                if st.metrics_snap is not None:
                    snaps[r.name] = st.metrics_snap
                elif self._routable(st, now):
                    missing.append(r)
        for r in missing:   # first serve before any prober pass
            self._scrape_metrics(r)
        if missing:
            with self._lock:
                for r in missing:
                    snap = self._states[r.name].metrics_snap
                    if snap is not None:
                        snaps[r.name] = snap
        merged = _aggregate.merge_snapshots(snaps)
        return _aggregate.overlay(merged, _metrics.snapshot())

    # -- SLO engine --------------------------------------------------------
    def attach_slo(self, engine, shed=None):
        """Evaluate ``engine`` over the aggregated stream on every probe
        sweep.  ``shed`` (default ``MXNET_FLEET_SLO_SHED``) turns on the
        shed hook: hedging — optional work — is disabled while any
        objective's fast window burns, restored when the alert clears.
        Returns the engine."""
        if shed is None:
            shed = env_flag("MXNET_FLEET_SLO_SHED", False)
        self._slo = engine
        if shed:
            prev_burn, prev_clear = engine._on_burn, engine._on_clear

            def on_burn(name):
                self._shed(True, name)
                if prev_burn is not None:
                    prev_burn(name)

            def on_clear(name):
                self._shed(False, name)
                if prev_clear is not None:
                    prev_clear(name)

            engine._on_burn, engine._on_clear = on_burn, on_clear
        return engine

    def _shed(self, burning, slo_name):
        with self._lock:
            if burning and not self._shedding:
                self._shedding = True
                self._hedge_saved = self.hedge
                self.hedge = False
            elif not burning and self._shedding \
                    and not self._slo.burning():
                self._shedding = False
                self.hedge = self._hedge_saved
            else:
                return
            hedge = self.hedge
        _flight.record("fleet.shed", slo=slo_name,
                       shedding=bool(burning), hedge=bool(hedge))

    # -- distributed tracing ----------------------------------------------
    def _mint_trace(self):
        """Mint a fleet trace id and open its routing-breakdown record.
        The id flows to replicas (in-process / ``X-MXNet-Trace``) so
        ONE id correlates router spans and replica scheduler events."""
        tid = "f%x-%x" % (os.getpid(), next(self._trace_ids))
        with self._lock:
            self._rtraces[tid] = {
                "trace_id": tid, "t0": self._clock(), "status": "submitted",
                "replica": None, "queue_at_router_s": None,
                "total_s": None, "attempts": [], "hedge": None,
            }
            while len(self._rtraces) > self._trace_cap:
                self._rtraces.popitem(last=False)
        _flight.record("fleet.submit", tid=tid)
        return tid

    def _rtrace(self, tid):
        return self._rtraces.get(tid) if tid else None

    def _trace_attempt(self, tid, replica, attempt, role, outcome, t_att):
        """One settled attempt — retry, hedge, or winner — as an
        attributed span: a ``fleet.attempt`` flight event carrying
        ``dur_s`` (rendered as a chrome span on the replica's row) and
        a row in the routing breakdown."""
        now = self._clock()
        dur = max(0.0, now - t_att)
        _flight.record("fleet.attempt", tid=tid or "", replica=replica,
                       attempt=attempt, role=role, outcome=outcome,
                       dur_s=round(dur, 6))
        with self._lock:
            tr = self._rtrace(tid)
            if tr is not None:
                tr["attempts"].append(
                    {"t": round(t_att - tr["t0"], 6), "replica": replica,
                     "attempt": attempt, "role": role, "outcome": outcome,
                     "dur_s": round(dur, 6)})

    def _trace_routed(self, tid):
        """First successful hand-off to a replica: the queue-at-router
        segment of the breakdown ends here."""
        with self._lock:
            tr = self._rtrace(tid)
            if tr is not None and tr["queue_at_router_s"] is None:
                tr["queue_at_router_s"] = round(
                    self._clock() - tr["t0"], 6)
                tr["status"] = "routed"

    def _finish_trace(self, tid, status, winner=None):
        """Terminal state of the fleet-side request: stamps the
        breakdown and records the router-row ``fleet.request`` span."""
        total = None
        with self._lock:
            tr = self._rtrace(tid)
            if tr is not None:
                total = round(self._clock() - tr["t0"], 6)
                tr["status"] = status
                tr["replica"] = winner
                tr["total_s"] = total
        if total is not None:
            _flight.record("fleet.request", tid=tid, status=status,
                           winner=winner or "", dur_s=total)

    def trace(self, trace_id):
        """Fleet-level ``GET /v1/trace/<id>``: the routing breakdown
        (queue-at-router, every attempt, hedge fire time) prepended to
        the owning replica's stored trace.  None when unknown."""
        with self._lock:
            tr = self._rtrace(trace_id)
            if tr is None:
                return None
            tr = dict(tr)
            tr["attempts"] = [dict(a) for a in tr["attempts"]]
            if tr["hedge"] is not None:
                tr["hedge"] = dict(tr["hedge"])
        owner = tr.get("replica")
        if owner is None and tr["attempts"]:
            owner = tr["attempts"][-1]["replica"]
        doc = {"trace_id": trace_id, "fleet": tr, "replica": owner,
               "replica_trace": None}
        rep = next((r for r in self._replicas if r.name == owner), None)
        if rep is not None:
            try:
                doc["replica_trace"] = rep.trace(trace_id)
            except Exception:  # noqa: BLE001 — breakdown still useful alone
                pass
        return doc

    # -- routing ----------------------------------------------------------
    def _routable(self, st, now):
        return (not st.ejected and not st.deploying and not st.draining
                and st.ok and now >= st.not_before_route)

    def _score(self, st):
        # queue depth x TPOT pace = estimated wait; router-side in-flight
        # reacts between probes.  Unknown pace scores by depth alone.
        return (st.queue_depth + st.inflight) * max(st.tpot, 1e-3)

    def _pick(self, exclude=(), prefer=None):
        now = self._clock()
        with self._lock:
            cands = [r for r in self._replicas
                     if r.name not in exclude
                     and self._routable(self._states[r.name], now)]
            # session affinity: the pinning replica wins over p2c
            # whenever it is routable at all (its cached pages beat a
            # shorter queue elsewhere); ejected/draining falls through
            preferred = None
            if prefer is not None:
                preferred = next((r for r in cands if r.name == prefer),
                                 None)
            if not cands:
                gates = [st.not_before_route - now
                         for st in self._states.values()
                         if not st.ejected and st.not_before_route > now]
                err = FleetNoHealthyReplica(
                    "no routable replica (%d total, %d ejected)"
                    % (len(self._replicas),
                       sum(1 for st in self._states.values()
                           if st.ejected)))
                err.retry_after_s = clamp_retry_after(
                    min(gates) if gates else 1.0)
                raise err
            if preferred is not None:
                chosen = preferred
            elif len(cands) == 1:
                chosen = cands[0]
            else:
                a, b = self._rng.sample(cands, 2)
                sa = self._score(self._states[a.name])
                sb = self._score(self._states[b.name])
                chosen = a if sa <= sb else b
            st = self._states[chosen.name]
            st.inflight += 1
            depth = st.queue_depth + st.inflight - 1
        if _metrics.enabled():
            _metrics.histogram(
                "mxnet_fleet_route_queue_depth",
                help="queue depth of the chosen replica at routing time",
                buckets=_ROUTE_DEPTH_BUCKETS).observe(depth)
        return chosen

    def _release(self, replica):
        with self._lock:
            self._states[replica.name].inflight -= 1

    def _note_transport_failure(self, replica, detail):
        """A forward-path transport failure is probe-grade evidence: it
        counts toward the breaker so a dead replica is ejected without
        waiting out the probe interval."""
        st = self._states[replica.name]
        with self._lock:
            st.failures += 1
            st.ok = False
            st.last_error = detail
        self._maybe_eject(replica, "forward_failure")

    def _gate(self, replica, retry_after_s):
        st = self._states[replica.name]
        with self._lock:
            st.not_before_route = max(
                st.not_before_route,
                self._clock() + clamp_retry_after(retry_after_s))

    # -- session affinity --------------------------------------------------
    def _affinity_hint(self, session):
        if session is None:
            return None
        with self._lock:
            name = self._affinity.get(session)
            if name is not None:
                self._affinity.move_to_end(session)
            return name

    def _affinity_note(self, session, name):
        if session is None:
            return
        with self._lock:
            self._affinity[session] = name
            self._affinity.move_to_end(session)
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)

    def pin_session(self, session, replica_name):
        """Register where a chat session lives — the caller opened it on
        that replica (``LlamaServer.open_session``), so its turns should
        route there.  Later successful turns refresh the pin."""
        if replica_name not in self._states:
            raise MXNetError("unknown replica %r (have %r)"
                             % (replica_name, sorted(self._states)))
        self._affinity_note(session, replica_name)

    # -- request path -----------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_s=None, timeout=300, idempotent=True,
               session=None):
        """Enqueue; routes and submits to a replica before returning, so
        decode starts immediately.  Returns a future whose
        ``.result(timeout)`` drives the retry/hedge state machine.
        ``session`` is a chat-session affinity hint: the turn routes to
        the replica that pinned the session's pages when that replica is
        routable, falling back to p2c otherwise.  The future carries the
        fleet trace id (``.trace_id``) for ``GET /v1/trace/<id>``."""
        return _FleetFuture(self, dict(
            prompt=prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            deadline_s=deadline_s, timeout=timeout, idempotent=idempotent,
            session=session, trace_id=self._mint_trace()))

    def _eager_submit(self, kwargs, deadline_t):
        """Attempt 0 on the submitter's thread: route and enqueue now so
        the request reaches a replica queue with no thread hop.  Errors
        are deferred into ``_generate`` (via ``_first``) where the
        normal gate/eject/retry accounting classifies them.  Returns
        ``(replica, handle, error)`` or None to start from scratch."""
        remaining = None
        if deadline_t is not None:
            remaining = deadline_t - self._clock()
            if remaining <= 0:
                return None  # the loop raises ServeDeadlineExceeded
        try:
            replica = self._pick(
                prefer=self._affinity_hint(kwargs.get("session")))
        except FleetNoHealthyReplica as e:
            return (None, None, e)
        try:
            _faults.maybe_inject("fleet_forward", replica=replica.name,
                                 attempt=0)
            handle = replica.submit(
                kwargs["prompt"],
                max_new_tokens=kwargs.get("max_new_tokens"),
                eos_id=kwargs.get("eos_id"), deadline_s=remaining,
                session=kwargs.get("session"),
                trace_id=kwargs.get("trace_id"))
            self._trace_routed(kwargs.get("trace_id"))
            return (replica, handle, None)
        except Exception as e:  # noqa: BLE001 — classified in _generate
            return (replica, None, e)

    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 deadline_s=None, timeout=300, idempotent=True,
                 session=None):
        """Blocking request through the full route/retry/hedge path."""
        return self._generate(None, prompt, max_new_tokens=max_new_tokens,
                              eos_id=eos_id, deadline_s=deadline_s,
                              timeout=timeout, idempotent=idempotent,
                              session=session,
                              trace_id=self._mint_trace())

    @staticmethod
    def _retry_reason(err):
        """Why a retry is allowed, or None for terminal errors."""
        if isinstance(err, ServeQueueFull):
            return "queue_full"
        if isinstance(err, ServeDraining):
            return "draining"
        if isinstance(err, ServeShutdown):
            return "shutdown"
        if isinstance(err, ServeInternalError):
            return "replica_failed"
        if isinstance(err, (ServeDeadlineExceeded, ServeCancelled)):
            return None
        if isinstance(err, _faults.FaultInjected):
            return "injected"
        if isinstance(err, (ConnectionError, TimeoutError, OSError)):
            return "connection"
        return None

    def _backoff(self, attempt):
        base = min(self.backoff_s * (2 ** attempt), _BACKOFF_CAP_S)
        with self._lock:
            jitter = 0.75 + 0.5 * self._rng.random()
        return base * jitter

    def _generate(self, future, prompt, max_new_tokens=None, eos_id=None,
                  deadline_s=None, timeout=300, idempotent=True,
                  session=None, trace_id=None, _first=None,
                  _deadline_t=None, _t0=None):
        if trace_id is None:
            trace_id = self._mint_trace()
        if _deadline_t is not None:
            deadline_t = _deadline_t
        else:
            deadline_t = None if deadline_s is None \
                else self._clock() + deadline_s
        t0 = self._clock() if _t0 is None else _t0
        tried = set()
        last_err = None
        for attempt in range(self.retries + 1):
            first, _first = (_first, None) if attempt == 0 else (None, None)
            remaining = None
            if deadline_t is not None:
                remaining = deadline_t - self._clock()
                if remaining <= 0:
                    if first is not None and first[0] is not None:
                        self._release(first[0])
                    with self._lock:
                        self.failed += 1
                    self._finish_trace(trace_id, "deadline")
                    raise last_err if isinstance(
                        last_err, ServeDeadlineExceeded) else \
                        ServeDeadlineExceeded(
                            "deadline_s=%.3f expired after %d attempt(s)"
                            % (deadline_s, attempt))
            if first is not None and first[0] is None:
                # eager routing found no healthy replica at submit time
                e = first[2]
                last_err = e
                if attempt >= self.retries:
                    with self._lock:
                        self.failed += 1
                    self._finish_trace(trace_id, "no_replica")
                    raise e
                self._count_retry("no_replica", None, attempt, trace_id)
                self._sleep(self._backoff(attempt))
                tried = set()
                continue
            if first is None:
                try:
                    replica = self._pick(
                        exclude=tried,
                        prefer=self._affinity_hint(session))
                except FleetNoHealthyReplica as e:
                    last_err = e
                    if attempt >= self.retries:
                        with self._lock:
                            self.failed += 1
                        self._finish_trace(trace_id, "no_replica")
                        raise
                    self._count_retry("no_replica", None, attempt,
                                      trace_id)
                    self._sleep(self._backoff(attempt))
                    # a fully-gated fleet may recover: forget per-attempt
                    # exclusions so a re-admitted replica is pickable
                    tried = set()
                    continue
            else:
                replica = first[0]
            tried.add(replica.name)
            # the eager attempt's span starts at submit() time (t0);
            # a retry attempt starts here
            t_att = t0 if first is not None else self._clock()
            try:
                if first is not None:
                    handle = first[1]
                    if first[2] is not None:
                        raise first[2]  # deferred eager-submit error
                else:
                    _faults.maybe_inject("fleet_forward",
                                         replica=replica.name,
                                         attempt=attempt)
                    handle = replica.submit(prompt,
                                            max_new_tokens=max_new_tokens,
                                            eos_id=eos_id,
                                            deadline_s=remaining,
                                            session=session,
                                            trace_id=trace_id)
                    self._trace_routed(trace_id)
                tokens, winner = self._await(handle, replica, tried,
                                             remaining, timeout,
                                             dict(prompt=prompt,
                                                  max_new_tokens=max_new_tokens,
                                                  eos_id=eos_id,
                                                  session=session,
                                                  trace_id=trace_id,
                                                  attempt=attempt))
            except (MXNetError, _faults.FaultInjected) as e:
                self._release(replica)
                reason = self._retry_reason(e)
                self._trace_attempt(trace_id, replica.name, attempt,
                                    "primary", reason or type(e).__name__,
                                    t_att)
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    self._gate(replica, retry_after)
                self._count_request(replica.name, reason or "error")
                # non-idempotent requests only retry refusals that
                # provably happened before any execution (submit-time)
                if reason is None or attempt >= self.retries or \
                        not (idempotent or isinstance(
                            e, (ServeQueueFull, ServeDraining,
                                _faults.FaultInjected))):
                    with self._lock:
                        self.failed += 1
                        if isinstance(e, ServeShutdown):
                            self.dropped += 1
                    last_err = e
                    self._finish_trace(trace_id, type(e).__name__)
                    raise
                last_err = e
                self._count_retry(reason, replica.name, attempt, trace_id)
                self._sleep(self._backoff(attempt))
                continue
            except (ConnectionError, TimeoutError, OSError) as e:
                self._release(replica)
                self._trace_attempt(trace_id, replica.name, attempt,
                                    "primary", "connection", t_att)
                self._note_transport_failure(
                    replica, "%s: %s" % (type(e).__name__, e))
                self._count_request(replica.name, "connection")
                # a broken transport after submit is ambiguous (the
                # request may have executed): never replay non-idempotent
                if attempt >= self.retries or not idempotent:
                    with self._lock:
                        self.failed += 1
                    self._finish_trace(trace_id, "unreachable")
                    raise MXNetError(
                        "replica %s unreachable after %d attempt(s): %s"
                        % (replica.name, attempt + 1, e))
                last_err = e
                self._count_retry("connection", replica.name, attempt,
                                  trace_id)
                self._sleep(self._backoff(attempt))
                continue
            self._release(replica)
            self._trace_attempt(trace_id, replica.name, attempt, "primary",
                                "ok" if winner.name == replica.name
                                else "lost_to_hedge", t_att)
            self._finish_trace(trace_id, "ok", winner.name)
            self._count_request(winner.name, "ok")
            self._affinity_note(session, winner.name)
            with self._lock:
                self.completed += 1
                self._lat.append(self._clock() - t0)
            if future is not None:
                future.replica = winner.name
                future.ttft = getattr(handle, "ttft", None)
            return tokens
        raise last_err  # pragma: no cover — loop always raises or returns

    def _await(self, handle, replica, tried, remaining, timeout, spec):
        """Wait for ``handle``; with hedging on, fire a second attempt
        on another replica after the p99-derived delay and return the
        first winner (cancelling the loser).  Returns (tokens, winner
        replica).  Every hedge-path transition is an attributed flight
        event — ``fleet.hedge`` when the duplicate fires,
        ``fleet.cancel`` when a loser is cancelled, ``fleet.attempt``
        (role=hedge) when the duplicate settles — all carrying the
        fleet trace id and attempt index."""
        budget = timeout if remaining is None else min(timeout, remaining)
        tid = spec.get("trace_id") or ""
        attempt = spec.get("attempt", 0)
        if not self.hedge or spec.get("session") is not None:
            # a session turn can only run where its pages are pinned —
            # hedging it to another replica is a guaranteed 404
            return handle.result(budget), replica
        delay = self._hedge_delay()
        if handle.wait(delay):
            return handle.result(budget), replica
        try:
            other = self._pick(exclude=tried | {replica.name})
        except FleetNoHealthyReplica:
            self._count_hedge("no_replica")
            return handle.result(budget), replica
        with self._lock:
            self.hedged += 1
        _flight.record("fleet.hedge", tid=tid, attempt=attempt,
                       primary=replica.name, hedge=other.name,
                       delay_s=round(delay, 6))
        with self._lock:
            tr = self._rtrace(tid)
            if tr is not None:
                tr["hedge"] = {"t": round(self._clock() - tr["t0"], 6),
                               "primary": replica.name,
                               "hedge": other.name,
                               "delay_s": round(delay, 6)}
        t_h2 = self._clock()
        h2 = other.submit(spec["prompt"],
                          max_new_tokens=spec["max_new_tokens"],
                          eos_id=spec["eos_id"], deadline_s=remaining,
                          trace_id=spec.get("trace_id"))

        def _hedge_settled(outcome):
            self._trace_attempt(tid, other.name, attempt, "hedge",
                                outcome, t_h2)

        def _cancel_loser(lh, lr):
            lh.cancel()
            _flight.record("fleet.cancel", tid=tid, attempt=attempt,
                           replica=lr.name,
                           role="hedge" if lh is h2 else "primary")
            if lh is h2:
                _hedge_settled("cancelled")

        try:
            pairs = [(handle, replica, "primary_won"),
                     (h2, other, "hedge_won")]
            deadline = self._clock() + budget
            errors = []
            while pairs:
                for i, (h, r, outcome) in enumerate(pairs):
                    if not h.done():
                        continue
                    if h.error is None:
                        if h is h2:
                            _hedge_settled("ok")
                        for lh, lr, _ in pairs[:i] + pairs[i + 1:]:
                            _cancel_loser(lh, lr)
                        self._count_hedge(outcome)
                        return h.result(0.001), r
                    errors.append(h.error)
                    if h is h2:
                        _hedge_settled(type(h.error).__name__)
                    pairs.pop(i)
                    break
                else:
                    if self._clock() >= deadline:
                        for lh, lr, _ in pairs:
                            _cancel_loser(lh, lr)
                        self._count_hedge("timeout")
                        raise errors[0] if errors else MXNetError(
                            "hedged request timed out after %ss" % budget)
                    pairs[0][0].wait(0.002)
            self._count_hedge("both_failed")
            raise errors[-1]
        finally:
            self._release(other)

    def _hedge_delay(self):
        if self.hedge_delay_s > 0:
            return self.hedge_delay_s
        with self._lock:
            data = sorted(self._lat)
        if len(data) >= 16:
            return data[int(0.99 * (len(data) - 1))]
        return 0.05  # cold fleet: a floor beats hedging instantly

    # -- telemetry helpers ------------------------------------------------
    @staticmethod
    def _count_request(replica, status):
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_fleet_requests_total",
                help="fleet requests by replica and final status",
                replica=replica, status=status).inc()

    def _count_retry(self, reason, replica, attempt, trace_id=None):
        with self._lock:
            self.retried += 1
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_fleet_retries_total",
                help="fleet request retries by reason", reason=reason).inc()
        _flight.record("fleet.retry", tid=trace_id or "", reason=reason,
                       replica=replica or "", attempt=attempt)

    @staticmethod
    def _count_hedge(outcome):
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_fleet_hedges_total",
                help="hedged attempts by outcome", outcome=outcome).inc()

    # -- fleet lifecycle --------------------------------------------------
    def rolling_deploy(self, bundle_path, timeout=120):
        """Deploy ``bundle_path`` one replica at a time with zero dropped
        requests: steer traffic away, hot-swap at a step boundary (PR
        15 ``reload()``), re-probe, re-admit.  Raises unless the fleet
        converged to one ``bundle_sha``.  Returns a report dict."""
        _flight.record("fleet.deploy", bundle=str(bundle_path),
                       phase="start", replicas=len(self._replicas))
        report = {"bundle": str(bundle_path), "replicas": [],
                  "dropped_before": self.dropped}
        for replica in self._replicas:
            st = self._states[replica.name]
            with self._lock:
                st.deploying = True
            self._update_healthy_gauge()
            try:
                replica.reload(bundle_path, timeout=timeout)
                self._probe_one(replica)
            finally:
                with self._lock:
                    st.deploying = False
            self._update_healthy_gauge()
            report["replicas"].append(
                {"replica": replica.name, "bundle_sha": st.bundle_sha,
                 "ok": st.ok})
            _flight.record("fleet.deploy", bundle=str(bundle_path),
                           phase="replica", replica=replica.name)
        shas = {r["bundle_sha"] for r in report["replicas"]}
        report["converged"] = len(shas) == 1
        report["bundle_sha"] = next(iter(shas)) if report["converged"] \
            else None
        report["dropped"] = self.dropped - report["dropped_before"]
        _flight.record("fleet.deploy", bundle=str(bundle_path),
                       phase="done", converged=report["converged"])
        if not report["converged"]:
            raise MXNetError(
                "rolling deploy did not converge: bundle_sha per replica "
                "%r" % ([(r["replica"], r["bundle_sha"])
                         for r in report["replicas"]],))
        return report

    def healthz(self):
        """The fleet-level GET /healthz body."""
        now = self._clock()
        with self._lock:
            replicas = {
                name: {"ok": st.ok, "ejected": st.ejected,
                       "draining": st.draining, "deploying": st.deploying,
                       "queue_depth": st.queue_depth,
                       "inflight": st.inflight,
                       "failures": st.failures,
                       "tpot_p50_s": st.tpot,
                       "arena_utilization": st.arena_util,
                       "bundle_sha": st.bundle_sha,
                       "last_error": st.last_error, "probes": st.probes}
                for name, st in self._states.items()}
            healthy = sum(1 for st in self._states.values()
                          if self._routable(st, now))
            shedding = self._shedding
        body = {
            "ok": healthy > 0,
            "replicas_healthy": healthy,
            "replicas_total": len(self._replicas),
            "completed": self.completed, "failed": self.failed,
            "retried": self.retried, "hedged": self.hedged,
            "ejections": self.ejections, "dropped": self.dropped,
            "replicas": replicas,
        }
        if self._slo is not None:
            body["slo"] = {"burning": sorted(
                name for name, b in self._slo._burning.items() if b),
                "shedding": shedding}
        return body

    def stats(self):
        return self.healthz()

    # -- HTTP front -------------------------------------------------------
    def serve_http(self, port=0, host="127.0.0.1"):
        """The fleet's own stdlib HTTP front: POST /v1/generate routes
        through the retry/hedge path; GET /healthz is the fleet view
        (503 + Retry-After when nothing is routable); GET /metrics
        (and /metrics.json) serves the AGGREGATED fleet snapshot —
        per-replica scrapes merged with a ``replica`` label, router
        families overlaid; GET /v1/trace/<id> is the fleet trace —
        routing breakdown prepended to the owning replica's trace."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        router = self

        def _code(err):
            if isinstance(err, ServeDeadlineExceeded):
                return 504
            if isinstance(err, ServeCancelled):
                return 409
            if isinstance(err, (FleetNoHealthyReplica, ServeShutdown,
                                ServeInternalError, ServeDraining,
                                ServeQueueFull)):
                return 503
            return 500

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: telemetry is the record
                pass

            def _send(self, code, body, ctype="application/json",
                      headers=None):
                payload = body.encode() if isinstance(body, str) \
                    else json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, _metrics.render_text(
                        router.fleet_metrics_snapshot()),
                        ctype="text/plain; version=0.0.4")
                elif self.path == "/metrics.json":
                    self._send(200, router.fleet_metrics_snapshot())
                elif self.path == "/healthz":
                    body = router.healthz()
                    if body["ok"]:
                        self._send(200, body)
                    else:
                        self._send(503, body,
                                   headers={"Retry-After": "1"})
                elif self.path.startswith("/v1/trace/"):
                    tid = self.path[len("/v1/trace/"):]
                    tr = router.trace(tid)
                    if tr is None:
                        self._send(404, {"error": "unknown trace id %r "
                                                  "(evicted or never seen)"
                                                  % tid})
                    else:
                        self._send(200, tr)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    fut = router.submit(
                        doc["prompt"],
                        max_new_tokens=doc.get("max_new_tokens"),
                        eos_id=doc.get("eos_id"),
                        deadline_s=doc.get("deadline_s"),
                        timeout=doc.get("timeout", 300),
                        idempotent=doc.get("idempotent", True))
                    tokens = fut.result(timeout=doc.get("timeout", 300))
                except (KeyError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                    return
                except MXNetError as e:
                    headers = None
                    retry_after = getattr(e, "retry_after_s", None)
                    if retry_after is not None:
                        headers = {"Retry-After":
                                   str(max(1, int(round(retry_after))))}
                    self._send(_code(e), {"error": str(e)},
                               headers=headers)
                    return
                self._send(200, {"tokens": tokens,
                                 "replica": fut.replica,
                                 "ttft_s": fut.ttft,
                                 "trace_id": fut.trace_id})

        self._http = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._http.serve_forever,
                         name="mxnet-fleet-http", daemon=True).start()
        return self._http.server_address


def fleet_drive_workload(router, workload, timeout=600,
                         clock=time.monotonic, sleep=time.sleep):
    """Replay a ``poisson_workload`` against a started router — the
    fleet twin of ``drive_workload``.  Returns ``(futures, wall_s)``."""
    t0 = clock()
    futs = []
    for arrival, req in workload:
        lag = arrival - (clock() - t0)
        if lag > 0:
            sleep(lag)
        futs.append(router.submit(req.prompt,
                                  max_new_tokens=req.max_new_tokens,
                                  eos_id=req.eos_id, timeout=timeout))
    for fut in futs:
        try:
            fut.result(timeout=timeout)
        except MXNetError:
            pass  # failures surface via fut.error
    return futs, clock() - t0
