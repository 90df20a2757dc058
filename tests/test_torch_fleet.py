"""The port's fleet tier (``mxnet_tpu_torch.serve.fleet``) on the CPU:
routing, retries, hedging, ejection and re-admission, rolling deploys,
the fleet HTTP front, the seeded chaos matrix, and the CLI.

The first part is the port's copy of the JAX package's own fleet tests
(``tests/test_fleet.py`` and the nine scenarios of
``tests/test_fleet_chaos.py``), on ``from_parts`` servers over a
deterministic numpy runner: no bundles, no model.

Parity with the JAX package, with the tolerance of each:

- the chaos matrix: for each scenario at ``MXNET_CHAOS_SEED``, the JAX
  package's router and the port's, each over three identical stub
  replicas, give EQUAL outcomes per request, EQUAL injection logs, EQUAL
  router counters and EQUAL ``mxnet_fleet_*`` counter series;
- the fleet over a real model: a seeded ``llama_small`` (2 layers,
  f32), served by two port replicas on the CPU behind a router, gives
  greedy tokens EQUAL to the JAX package's server over live-jitted step
  functions (no MXAOT1 bundle on the path);
- real port bundles (``.npz``): a two-replica fleet gives tokens EQUAL
  to one server on the same bundle and one ``bundle_sha`` fleet-wide; a
  rolling deploy mid-stream drops nothing; ``python -m
  mxnet_tpu_torch.serve --fleet 2 --device cpu`` drains on SIGTERM and
  exits 0.
"""
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import serve as jserve
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.gluon.model_zoo.llama import llama_small
from mxnet_tpu.serve import model as jm
from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.testing import faults as jfaults
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (FleetNoHealthyReplica, FleetRouter,
                                   LocalReplica, PagedKVArena, Request,
                                   ServeCancelled, ServeDeadlineExceeded,
                                   ServeDraining, ServeQueueFull,
                                   ServeSessionUnknown, ServeShutdown,
                                   clamp_retry_after)
from mxnet_tpu_torch.serve.model import KVGeometry
from mxnet_tpu_torch.serve.scheduler import ServeInternalError
from mxnet_tpu_torch.serve.server import (LlamaServer, TorchRunner,
                                          drive_workload, poisson_workload)
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.testing import faults
from mxnet_tpu_torch.testing.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = int(os.environ.get("MXNET_CHAOS_SEED", "1337"))

TINY = dict(num_layers=1, num_heads=2, num_kv_heads=1, head_dim=4,
            units=8, hidden_size=16, vocab_size=32, page_size=4,
            num_pages=9, max_pages_per_seq=4, max_batch=2,
            prefill_buckets=(4, 8))


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.uninstall()


def tiny_geometry(**over):
    kw = dict(TINY)
    kw.update(over)
    return KVGeometry(**kw)


class StubRunner:
    """Deterministic logits: one-hot at (calls + lane) % vocab."""

    def __init__(self, g, step_delay=0.0):
        self.g = g
        self.calls = 0
        self.step_delay = step_delay

    def _logits(self, n):
        out = np.zeros((n, self.g.vocab_size), dtype=np.float32)
        for i in range(n):
            out[i, (self.calls + i) % self.g.vocab_size] = 1.0
        self.calls += 1
        if self.step_delay:
            time.sleep(self.step_delay)
        return out

    def prefill(self, bucket, tokens, length, block_row):
        return self._logits(1)[0]

    def decode(self, tokens, positions, block_tables):
        return self._logits(self.g.max_batch)

    def chunk(self, tokens, positions, block_tables):
        b, c = tokens.shape
        out = np.zeros((b, c, self.g.vocab_size), dtype=np.float32)
        for i in range(b):
            for j in range(c):
                out[i, j, (self.calls + i + j) % self.g.vocab_size] = 1.0
        self.calls += 1
        return out


def make_server(start=True, step_delay=0.0, **geom):
    g = tiny_geometry(**geom)
    srv = LlamaServer.from_parts(StubRunner(g, step_delay=step_delay),
                                 PagedKVArena(g, device="cpu"), queue_depth=8)
    if start:
        srv.start()
    return srv


def make_fleet(n=3, start_router=True, router_kw=None, **server_kw):
    servers = [make_server(**server_kw) for _ in range(n)]
    reps = [LocalReplica(s, name="r%d" % i) for i, s in enumerate(servers)]
    kw = dict(probe_interval=0, retries=2, backoff_s=0.001, seed=0,
              sleep=lambda s: None)
    kw.update(router_kw or {})
    router = FleetRouter(reps, **kw)
    if start_router:
        router.start(poller=False)
    return servers, router


def shutdown(router, servers):
    router.stop()
    for s in servers:
        s.drain(timeout=10)
        s.stop()
        s.arena.assert_quiescent()


# -- routing -------------------------------------------------------------

def test_pick_routes_to_lower_queue_depth():
    servers, router = make_fleet(2)
    try:
        router._states["r0"].queue_depth = 8
        router._states["r0"].tpot = 0.01
        router._states["r1"].queue_depth = 1
        router._states["r1"].tpot = 0.01
        picks = set()
        for _ in range(8):
            r = router._pick()
            picks.add(r.name)
            router._release(r)
        # power-of-two over 2 candidates degenerates to best-of-both
        assert picks == {"r1"}
    finally:
        shutdown(router, servers)


def test_pick_skips_ejected_draining_and_gated():
    servers, router = make_fleet(3)
    try:
        router._states["r0"].ejected = True
        router._states["r1"].draining = True
        assert router._pick().name == "r2"
        router._release(router._replicas[2])
        # gate r2 too: nothing routable, hint from the nearest gate
        router._gate(router._replicas[2], 0.2)
        with pytest.raises(FleetNoHealthyReplica) as ei:
            router._pick()
        assert 0.05 <= ei.value.retry_after_s <= 30.0
    finally:
        shutdown(router, servers)


def test_inflight_counts_against_score():
    servers, router = make_fleet(2)
    try:
        # equal probes; pile router-side in-flight onto r0
        router._states["r0"].inflight = 5
        router._states["r0"].tpot = 0.01
        router._states["r1"].tpot = 0.01
        r = router._pick()
        assert r.name == "r1"
        router._release(r)
    finally:
        shutdown(router, servers)


# -- retries + backoff ---------------------------------------------------

def test_backoff_doubles_caps_and_jitters():
    servers, router = make_fleet(1, router_kw=dict(backoff_s=1.0))
    try:
        for attempt, base in [(0, 1.0), (1, 2.0), (2, 4.0), (3, 5.0),
                              (10, 5.0)]:
            for _ in range(16):
                b = router._backoff(attempt)
                assert 0.75 * base <= b <= 1.25 * base
    finally:
        shutdown(router, servers)


def test_retry_reason_classification():
    rr = FleetRouter._retry_reason
    assert rr(ServeQueueFull("x")) == "queue_full"
    assert rr(ServeDraining("x")) == "draining"
    assert rr(ServeShutdown("x")) == "shutdown"
    assert rr(ServeInternalError("x")) == "replica_failed"
    assert rr(ConnectionResetError("x")) == "connection"
    assert rr(faults.FaultInjected("x")) == "injected"
    # terminal: retrying cannot help / must not happen
    assert rr(ServeDeadlineExceeded("x")) is None
    assert rr(ServeCancelled("x")) is None
    assert rr(MXNetError("x")) is None


def test_queue_full_retries_on_other_replica_and_gates():
    servers, router = make_fleet(2)
    try:
        # r0 refuses with queue-full at the fleet_forward site
        faults.install(FaultPlan(seed=1, rules=[]))
        faults.uninstall()
        sched0 = servers[0].scheduler

        real_submit = sched0.submit

        def full_submit(req):
            err = ServeQueueFull("queue full (test)")
            err.retry_after_s = 0.2
            raise err

        sched0.submit = full_submit
        try:
            tokens = [router.generate([1, 2], max_new_tokens=2, timeout=30)
                      for _ in range(4)]
        finally:
            sched0.submit = real_submit
        assert all(len(t) == 2 for t in tokens)
        assert router.retried >= 1
        st = router.healthz()["replicas"]["r0"]
        # the queue-full hint gated r0 out of the candidate set
        assert router._states["r0"].not_before_route > 0
        assert st["ok"]  # backpressure is not a health failure
    finally:
        shutdown(router, servers)


def test_retries_exhausted_raises_last_error():
    servers, router = make_fleet(2, router_kw=dict(retries=1))
    try:
        faults.install(FaultPlan(seed=1, rules=[
            {"site": "fleet_forward", "action": "raise", "times": 0}]))
        with pytest.raises(faults.FaultInjected):
            router.generate([1], max_new_tokens=1, timeout=10)
        assert router.failed == 1
        assert router.retried == 1   # one retry, on the other replica
    finally:
        faults.uninstall()
        shutdown(router, servers)


def test_non_idempotent_requests_do_not_retry_mid_flight():
    servers, router = make_fleet(2)
    try:
        # mid-flight failure (replica died after accept) on first attempt
        faults.install(FaultPlan(seed=1, rules=[
            {"site": "replica_kill", "action": "kill_loop", "times": 1}]))
        with pytest.raises(MXNetError, match="unreachable"):
            router.generate([1, 2], max_new_tokens=2, timeout=10,
                            idempotent=False)
        faults.uninstall()
        # submit-time refusals still retry for non-idempotent requests
        sched = None
        for srv in servers:
            if srv.healthy():
                sched = srv.scheduler
        assert sched is not None
        tokens = router.generate([1, 2], max_new_tokens=2, timeout=10,
                                 idempotent=False)
        assert len(tokens) == 2
    finally:
        shutdown(router, servers)


def test_deadline_decrements_and_expires_across_attempts():
    clk = itertools.count()
    servers, router = make_fleet(
        2, router_kw=dict(clock=lambda: next(clk) * 0.3))
    try:
        seen = []
        for r in router._replicas:
            real = r.submit

            def spy(prompt, real=real, **kw):
                seen.append(kw.get("deadline_s"))
                return real(prompt, **kw)

            r.submit = spy
        faults.install(FaultPlan(seed=1, rules=[
            {"site": "fleet_forward", "action": "refuse", "times": 1}]))
        with pytest.raises(ServeDeadlineExceeded):
            # the clock advances 0.3s per read: a 1s budget dies during
            # the retry dance, not in a replica
            router.generate([1], max_new_tokens=1, deadline_s=1.0,
                            timeout=10)
        # every propagated deadline was the *remaining* budget
        assert all(d is None or d < 1.0 for d in seen)
    finally:
        faults.uninstall()
        shutdown(router, servers)


def test_zero_deadline_raises_before_any_submit():
    servers, router = make_fleet(1)
    try:
        with pytest.raises(ServeDeadlineExceeded):
            router.generate([1], max_new_tokens=1, deadline_s=0.0)
        assert router.completed == 0
    finally:
        shutdown(router, servers)


# -- ejection + re-admission --------------------------------------------

def test_probe_failures_eject_then_half_open_readmits():
    clk = itertools.count()
    servers, router = make_fleet(
        2, start_router=False,
        router_kw=dict(eject_after=2, readmit_after_s=0.5,
                       clock=lambda: next(clk) * 0.1))
    try:
        faults.install(FaultPlan(seed=1337, rules=[
            {"site": "fleet_probe", "action": "raise",
             "match": {"replica": "r1"}, "times": 2}]))
        router.start(poller=False)   # probe 1: r1 fails
        router.probe_all()           # probe 2: r1 fails -> ejected
        faults.uninstall()
        st = router.healthz()["replicas"]["r1"]
        assert st["ejected"] and st["failures"] == 2
        assert router.ejections == 1
        # fleet still serves on r0 while r1 is out
        assert router.generate([5, 6], max_new_tokens=2, timeout=30) \
            == [0, 1]
        # breaker stays open until readmit_after_s has elapsed
        before = router._states["r1"].probes
        router.probe_all()
        # ... then the half-open probe goes through and re-admits
        for _ in range(10):
            router.probe_all()
        st = router.healthz()["replicas"]["r1"]
        assert not st["ejected"] and st["ok"]
        assert st["probes"] > before
    finally:
        shutdown(router, servers)


def test_transport_failure_counts_toward_breaker():
    servers, router = make_fleet(2, router_kw=dict(eject_after=1))
    try:
        faults.install(FaultPlan(seed=1337, rules=[
            {"site": "replica_kill", "action": "kill_loop",
             "match": {"replica": "r1"}, "times": 1}]))
        for i in range(6):
            router.generate([1 + i], max_new_tokens=2, timeout=30)
        faults.uninstall()
        st = router.healthz()["replicas"]["r1"]
        # the dead transport ejected r1 without waiting for a probe
        assert st["ejected"] and not st["ok"]
        assert not servers[1].healthy()   # loop crash flipped sticky not-ok
    finally:
        shutdown(router, servers)


def test_draining_replica_is_steered_around_not_ejected():
    servers, router = make_fleet(2, start_router=False)
    try:
        servers[0].scheduler.drain()
        servers[0]._draining = True
        router.start(poller=False)
        for i in range(4):
            router.generate([1 + i], max_new_tokens=2, timeout=30)
        st = router.healthz()["replicas"]["r0"]
        assert st["draining"] and not st["ejected"]
        assert st["failures"] == 0   # deliberate, not a fault
    finally:
        shutdown(router, servers)


# -- hedging -------------------------------------------------------------

def test_hedge_wins_when_primary_hangs():
    servers, router = make_fleet(
        2, router_kw=dict(hedge=True, hedge_delay_s=0.01))
    try:
        faults.install(FaultPlan(seed=1337, rules=[
            {"site": "replica_hang", "action": "raise",
             "match": {"replica": "r0"}, "times": 1}]))
        tokens = None
        for i in range(4):   # one of these lands on r0 and hangs
            tokens = router.generate([2 + i], max_new_tokens=2, timeout=20)
        faults.uninstall()
        assert router.hedged >= 1
        assert tokens is not None and len(tokens) == 2
        assert router.failed == 0
    finally:
        shutdown(router, servers)


def test_hedge_not_fired_when_primary_fast():
    servers, router = make_fleet(
        2, router_kw=dict(hedge=True, hedge_delay_s=5.0))
    try:
        for i in range(4):
            router.generate([1 + i], max_new_tokens=2, timeout=20)
        assert router.hedged == 0
    finally:
        shutdown(router, servers)


def test_hedge_delay_uses_p99_when_warm():
    servers, router = make_fleet(1, router_kw=dict(hedge=True))
    try:
        assert router._hedge_delay() == pytest.approx(0.05)  # cold floor
        with router._lock:
            for i in range(100):
                router._lat.append(0.001 * (i + 1))
        d = router._hedge_delay()
        assert 0.09 <= d <= 0.1   # p99 of 1..100 ms
    finally:
        shutdown(router, servers)


# -- rolling deploy ------------------------------------------------------

def chaos_reload(srv, runner_factory=None):
    """Scripted hot-swap for from_parts servers (no bundle on disk):
    same ``_pending_swap`` machinery ``reload()`` uses, minus the
    loader."""
    def fn(path, timeout):
        g = srv.geometry
        runner = (runner_factory or (lambda: StubRunner(g)))()
        done = threading.Event()
        with srv._swap_lock:
            srv._pending_swap = (g, runner, PagedKVArena(g, device="cpu"), path, done)
        srv.scheduler.kick()
        assert done.wait(timeout), "swap never landed"
    return fn


def test_rolling_deploy_converges_with_zero_dropped():
    servers = [make_server() for _ in range(3)]
    reps = [LocalReplica(s, name="d%d" % i, reload_fn=chaos_reload(s))
            for i, s in enumerate(servers)]
    router = FleetRouter(reps, probe_interval=0, retries=2,
                         backoff_s=0.001, seed=0, sleep=lambda s: None)
    router.start(poller=False)
    try:
        report = router.rolling_deploy("bundle-b", timeout=10)
        assert report["converged"]
        assert report["dropped"] == 0
        assert len({r["bundle_sha"] for r in report["replicas"]}) == 1
        # the fleet serves on the new bundle
        assert len(router.generate([1, 2], max_new_tokens=2,
                                   timeout=30)) == 2
    finally:
        shutdown(router, servers)


def test_rolling_deploy_divergence_raises():
    servers = [make_server() for _ in range(2)]

    def stuck_reload(path, timeout):
        pass  # replica 1 silently keeps its old (None) bundle_sha

    reps = [LocalReplica(servers[0], name="d0",
                         reload_fn=chaos_reload(servers[0])),
            LocalReplica(servers[1], name="d1", reload_fn=stuck_reload)]
    router = FleetRouter(reps, probe_interval=0, retries=0,
                         backoff_s=0.001, seed=0, sleep=lambda s: None)
    router.start(poller=False)
    try:
        with pytest.raises(MXNetError, match="did not converge"):
            router.rolling_deploy("bundle-b", timeout=10)
    finally:
        shutdown(router, servers)


def test_deploying_replica_is_not_routable():
    servers, router = make_fleet(2)
    try:
        router._states["r0"].deploying = True
        for _ in range(4):
            r = router._pick()
            assert r.name == "r1"
            router._release(r)
    finally:
        shutdown(router, servers)


# -- fleet HTTP front ----------------------------------------------------

def _post(base, doc, timeout=30):
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_fleet_http_generate_healthz_metrics():
    servers, router = make_fleet(2)
    host, port = router.serve_http(port=0)
    base = "http://%s:%d" % (host, port)
    try:
        out = _post(base, {"prompt": [1, 2], "max_new_tokens": 3})
        assert len(out["tokens"]) == 3
        assert out["replica"] in ("r0", "r1")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            body = json.loads(r.read())
        assert body["ok"] and body["replicas_healthy"] == 2
        assert body["completed"] >= 1
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "mxnet_fleet_requests_total" in text
    finally:
        shutdown(router, servers)


def test_fleet_http_503_with_retry_after_when_nothing_routable():
    servers, router = make_fleet(
        2, router_kw=dict(retries=0))
    host, port = router.serve_http(port=0)
    base = "http://%s:%d" % (host, port)
    try:
        for name in ("r0", "r1"):
            router._states[name].ejected = True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": [1], "max_new_tokens": 1})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
    finally:
        shutdown(router, servers)


def test_fleet_future_resolves_with_replica_and_ttft():
    servers, router = make_fleet(2)
    try:
        fut = router.submit([1, 2, 3], max_new_tokens=2, timeout=30)
        tokens = fut.result(timeout=30)
        assert len(tokens) == 2
        assert fut.replica in ("r0", "r1")
        assert fut.error is None
    finally:
        shutdown(router, servers)


# -- satellite: healthz identity fields ----------------------------------

def test_healthz_reports_server_id_uptime_and_bundle_sha():
    a, b = make_server(start=False), make_server(start=False)
    try:
        ha, hb = a.healthz(), b.healthz()
        assert ha["server_id"] != hb["server_id"]
        assert ha["server_id"].startswith("srv-")
        assert ha["uptime_s"] >= 0.0
        assert ha["bundle_sha"] is None   # from_parts: no bundle file
        time.sleep(0.02)
        assert a.healthz()["uptime_s"] > ha["uptime_s"]
    finally:
        for s in (a, b):
            s.stop()


# -- satellite: Retry-After clamp ----------------------------------------

def test_clamp_retry_after_band():
    assert clamp_retry_after(0.001) == 0.05
    assert clamp_retry_after(1e9) == 30.0
    assert clamp_retry_after(2.5) == 2.5
    assert clamp_retry_after(-3) == 0.05


def test_retry_after_cold_start_is_one_second():
    srv = make_server(start=False)
    try:
        # no queue, no TPOT signal: the conventional 1 s hint
        assert srv.scheduler.retry_after_s() == 1.0
    finally:
        srv.stop()


def test_retry_after_deep_queue_capped_and_floored():
    srv = make_server(start=False)
    try:
        sched = srv.scheduler
        for _ in range(4):   # 2 land in slots, 2 stay queued
            sched.submit(Request([1, 2], max_new_tokens=10))
        assert sched.stats()["queue_len"] >= 1
        sched._t_decode = 10.0   # pathological pace: est ~ minutes
        assert sched.retry_after_s() == 30.0
        sched._t_decode = 1e-6   # absurdly fast: est ~ microseconds
        assert sched.retry_after_s() == 0.05
    finally:
        srv.start()
        srv.drain(timeout=10)
        srv.stop()
        srv.arena.assert_quiescent()


# -- satellite: workload determinism -------------------------------------

def test_poisson_workload_is_seed_deterministic():
    kw = dict(n_requests=24, rate_rps=500.0, prompt_range=(2, 10),
              max_new_range=(2, 12), vocab_size=32, seed=7)
    wa, wb = poisson_workload(**kw), poisson_workload(**kw)
    assert [t for t, _ in wa] == [t for t, _ in wb]
    assert [r.prompt for _, r in wa] == [r.prompt for _, r in wb]
    assert [r.max_new_tokens for _, r in wa] \
        == [r.max_new_tokens for _, r in wb]
    wc = poisson_workload(**dict(kw, seed=8))
    assert [r.prompt for _, r in wa] != [r.prompt for _, r in wc]


def test_drive_workload_outcomes_deterministic_across_runs():
    def run():
        g = tiny_geometry()
        srv = LlamaServer.from_parts(StubRunner(g), PagedKVArena(g, device="cpu"),
                                     queue_depth=32)  # no racy shedding
        srv.start()
        try:
            wl = poisson_workload(16, rate_rps=2000.0, prompt_range=(2, 6),
                                  max_new_range=(2, 6), vocab_size=32,
                                  seed=3)
            reqs, _ = drive_workload(srv, wl, timeout=60,
                                     sleep=lambda s: None)
            # exact tokens depend on decode-batch interleaving (the
            # stub's one-hot index advances per step); drive_workload's
            # deterministic contract is the request set + outcome shape
            return [(("ok", len(r.prompt), len(r.tokens))
                     if r.error is None else
                     (type(r.error).__name__,)) for r in reqs]
        finally:
            srv.drain(timeout=10)
            srv.stop()
            srv.arena.assert_quiescent()

    assert run() == run()


# -- satellite: HTTP client disconnect cancels the request ---------------

def test_http_client_disconnect_cancels_and_frees_pages():
    srv = make_server(step_delay=0.02)   # ~20 ms/step: time to hang up
    host, port = srv.serve_http(port=0)
    try:
        cancelled = []
        real_cancel = srv.scheduler.cancel

        def spy(tid):
            ok = real_cancel(tid)
            cancelled.append((tid, ok))
            return ok

        srv.scheduler.cancel = spy
        sock = socket.create_connection((host, port), timeout=10)
        body = json.dumps({"prompt": [1, 2],
                           "max_new_tokens": 12}).encode()
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                     b"Host: x\r\nContent-Type: application/json\r\n"
                     + ("Content-Length: %d\r\n\r\n"
                        % len(body)).encode() + body)
        time.sleep(0.08)          # a few decode steps in...
        sock.close()              # ...client gives up
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not cancelled:
            time.sleep(0.02)
        assert cancelled and cancelled[0][1] is True
    finally:
        srv.drain(timeout=10)
        srv.stop()
    srv.arena.assert_quiescent()   # cancelled request's pages came back


# -- chat-session affinity routing ----------------------------------------

def test_pick_prefers_affinity_replica_over_p2c():
    servers, router = make_fleet(3)
    try:
        # the pinned replica looks WORSE than everyone else on the p2c
        # score — its cached session pages must win anyway
        router._states["r1"].queue_depth = 64
        router._states["r1"].tpot = 0.05
        router.pin_session("sess-a", "r1")
        for _ in range(6):
            r = router._pick(prefer=router._affinity_hint("sess-a"))
            assert r.name == "r1"
            router._release(r)
    finally:
        shutdown(router, servers)


def test_affinity_falls_back_to_p2c_when_pinned_unroutable():
    servers, router = make_fleet(3)
    try:
        router.pin_session("sess-a", "r1")
        router._states["r1"].ejected = True
        for _ in range(6):
            r = router._pick(prefer=router._affinity_hint("sess-a"))
            assert r.name in ("r0", "r2")
            router._release(r)
    finally:
        shutdown(router, servers)


def test_pin_session_rejects_unknown_replica():
    servers, router = make_fleet(2)
    try:
        with pytest.raises(MXNetError, match="unknown replica"):
            router.pin_session("sess-a", "nope")
    finally:
        shutdown(router, servers)


def test_session_turns_route_to_pinning_replica():
    servers, router = make_fleet(3, prefill_chunk=2)
    try:
        sid = servers[1].open_session()
        router.pin_session(sid, "r1")
        out1 = router.generate([1, 2, 3], max_new_tokens=2, session=sid)
        out2 = router.generate([4, 5], max_new_tokens=2, session=sid)
        assert len(out1) == 2 and len(out2) == 2
        # both turns landed on the pinning replica: its scheduler holds
        # the whole history, the other replicas served nothing
        sess = servers[1].scheduler._sessions[sid]
        assert len(sess.tokens) == 3 + 2 + 2 + 2
        assert servers[0].scheduler.admitted == 0
        assert servers[2].scheduler.admitted == 0
        assert servers[1].close_session(sid) is True
    finally:
        shutdown(router, servers)


def test_session_turn_fails_typed_when_pinned_replica_ejected():
    servers, router = make_fleet(3, prefill_chunk=2)
    try:
        sid = servers[1].open_session()
        router.pin_session(sid, "r1")
        router._states["r1"].ejected = True
        # p2c fallback lands on a replica without the session's pages —
        # the failure is typed (404 semantics), never a hang or retry
        # storm (session errors are terminal, not retryable)
        with pytest.raises(ServeSessionUnknown):
            router.generate([1, 2], max_new_tokens=2, session=sid)
        assert servers[1].close_session(sid) is True
    finally:
        shutdown(router, servers)


# -- the seeded chaos matrix ---------------------------------------------
# Determinism recipe: ``from_parts`` servers over ``StubRunner`` (token
# streams are a pure function of how many runner calls came before),
# a counter clock on the router, ``poller=False`` (the test drives
# ``probe_all()``), a no-op ``sleep``, a seeded router RNG, and fault
# rules that use ``times`` / ``match`` only.  Requests are issued
# sequentially and blocking, so routing depends only on probe state and
# the seeded RNG; any failure reproduces from ``MXNET_CHAOS_SEED`` alone.

# one package's fleet surface: the port's, or the JAX package's
PORT = types.SimpleNamespace(
    KVGeometry=KVGeometry, LlamaServer=LlamaServer,
    arena=lambda g: PagedKVArena(g, device="cpu"),
    FleetRouter=FleetRouter, LocalReplica=LocalReplica, faults=faults,
    errors=(MXNetError, faults.FaultInjected), metrics=tmetrics)
JAX = types.SimpleNamespace(
    KVGeometry=jm.KVGeometry, LlamaServer=jserve.LlamaServer,
    arena=jserve.PagedKVArena, FleetRouter=jserve.FleetRouter,
    LocalReplica=jserve.LocalReplica, faults=jfaults,
    errors=(JaxMXNetError, jfaults.FaultInjected), metrics=jmetrics)


def counter_clock(step=0.01):
    counter = itertools.count()
    return lambda: next(counter) * step


def chaos_swap(pkg, srv):
    """Scripted hot-swap (from_parts servers have no bundle file)."""
    def fn(path, timeout):
        g = srv.geometry
        done = threading.Event()
        with srv._swap_lock:
            srv._pending_swap = (g, StubRunner(g), pkg.arena(g), path, done)
        srv.scheduler.kick()
        assert done.wait(timeout), "swap never landed"
    return fn


def fleet_counters(metrics):
    """Every non-zero ``mxnet_fleet_*`` counter series, by family."""
    out = {}
    for name, fam in sorted(metrics.snapshot().items()):
        series = sorted((tuple(sorted(s["labels"].items())), s["value"])
                        for s in fam["series"] if s.get("value"))
        if name.startswith("mxnet_fleet_") and fam["type"] == "counter" \
                and series:
            out[name] = series
    return out


def run_fleet_scenario(pkg, rules, n_requests=12, hedge=False,
                       deploy_at=None, eject_after=2, readmit_after_s=0.1,
                       retries=2):
    """One fleet chaos run on ``pkg``.  Returns (outcomes, events,
    counters, fleet counter series): everything the run-twice and the
    cross-package identities compare."""
    pkg.metrics.reset()
    servers, reps = [], []
    for i in range(3):
        g = pkg.KVGeometry(**TINY)
        srv = pkg.LlamaServer.from_parts(StubRunner(g), pkg.arena(g),
                                         queue_depth=8)
        srv.start()
        servers.append(srv)
        reps.append(pkg.LocalReplica(srv, name="r%d" % i,
                                     reload_fn=chaos_swap(pkg, srv)))
    router = pkg.FleetRouter(
        reps, probe_interval=0, retries=retries, backoff_s=0.001,
        # the hedge waits in real time: 0.5 s outlasts any healthy stub
        # request on a loaded host, so only the injected hang hedges and
        # every run makes the same decisions
        hedge=hedge, hedge_delay_s=0.5 if hedge else None,
        eject_after=eject_after, readmit_after_s=readmit_after_s,
        seed=SEED, clock=counter_clock(), sleep=lambda s: None)
    plan = pkg.faults.install(pkg.faults.FaultPlan(seed=SEED, rules=rules))
    outcomes = []
    try:
        router.start(poller=False)
        for i in range(n_requests):
            if deploy_at is not None and i == deploy_at:
                report = router.rolling_deploy("bundle-b", timeout=30)
                outcomes.append(("deploy", report["converged"],
                                 report["dropped"]))
            try:
                toks = router.generate([1 + (i % 8), 2],
                                       max_new_tokens=3, timeout=60)
                outcomes.append(("ok", tuple(toks)))
            except pkg.errors as e:
                outcomes.append((type(e).__name__,))
            router.probe_all()
        events = [(e["site"], e["action"], e["rule"],
                   e["ctx"].get("replica")) for e in plan.events]
        counters = dict(completed=router.completed, failed=router.failed,
                        retried=router.retried, hedged=router.hedged,
                        ejections=router.ejections, dropped=router.dropped)
    finally:
        pkg.faults.uninstall()
        router.stop()
        for srv in servers:
            srv.drain(timeout=10)
            srv.stop()
            srv.arena.assert_quiescent()   # leak-free under chaos
    return outcomes, events, counters, fleet_counters(pkg.metrics)


SCENARIOS = {
    "baseline": dict(rules=[]),
    "replica_kill": dict(
        rules=[{"site": "replica_kill", "action": "kill_loop",
                "match": {"replica": "r1"}, "times": 1}],
        eject_after=1),
    "replica_hang": dict(
        rules=[{"site": "replica_hang", "action": "raise",
                "match": {"replica": "r0"}, "times": 1}],
        hedge=True),
    "replica_slow": dict(
        rules=[{"site": "replica_slow", "action": "delay",
                "delay": 0.02, "times": 3}]),
    "probe_faults": dict(
        rules=[{"site": "fleet_probe", "action": "raise",
                "match": {"replica": "r2"}, "times": 3}],
        n_requests=16),
    "forward_faults": dict(
        rules=[{"site": "fleet_forward", "action": "raise", "times": 2}]),
    "rolling_deploy": dict(rules=[], deploy_at=6, n_requests=12),
    "fleet_outage": dict(
        rules=[{"site": "fleet_probe", "action": "raise", "times": 6}],
        n_requests=16, eject_after=2, readmit_after_s=0.05, retries=1),
    "compound_storm": dict(
        rules=[
            {"site": "replica_kill", "action": "kill_loop",
             "match": {"replica": "r0"}, "times": 1},
            {"site": "fleet_probe", "action": "raise",
             "match": {"replica": "r1"}, "times": 2},
            {"site": "fleet_forward", "action": "raise", "times": 1},
        ],
        n_requests=16, eject_after=2),
}


def assert_twice_identical(scenario):
    """The headline guarantee: the whole run is a pure function of the
    seed.  Returns the (shared) first run for further assertions."""
    a = run_fleet_scenario(PORT, **SCENARIOS[scenario])
    b = run_fleet_scenario(PORT, **SCENARIOS[scenario])
    assert a == b, "chaos run diverged for seed %d" % SEED
    return a[:3]


def test_baseline_no_faults_all_complete():
    outcomes, events, counters = assert_twice_identical("baseline")
    assert events == []
    assert all(o[0] == "ok" for o in outcomes)
    assert counters["completed"] == len(outcomes)
    assert counters["failed"] == counters["dropped"] == 0


def test_replica_kill_retries_and_ejects():
    outcomes, events, counters = assert_twice_identical("replica_kill")
    # the kill is retried on another replica: no request is lost
    assert all(o[0] == "ok" for o in outcomes)
    assert counters["retried"] >= 1
    assert counters["ejections"] == 1   # dead transport tripped breaker
    assert counters["failed"] == 0
    assert [e[0] for e in events] == ["replica_kill"]


def test_replica_hang_hedge_completes_request():
    outcomes, events, counters = assert_twice_identical("replica_hang")
    assert all(o[0] == "ok" for o in outcomes)
    assert counters["hedged"] >= 1   # the hang forced exactly this path
    assert counters["failed"] == 0
    assert [e[0] for e in events] == ["replica_hang"]


def test_replica_slow_delays_but_completes():
    outcomes, events, counters = assert_twice_identical("replica_slow")
    assert all(o[0] == "ok" for o in outcomes)
    assert counters["retried"] == 0   # slow is not broken
    assert len(events) == 3


def test_probe_faults_eject_then_readmit():
    outcomes, events, counters = assert_twice_identical("probe_faults")
    assert all(o[0] == "ok" for o in outcomes)   # fleet absorbs it
    assert counters["ejections"] >= 1
    # after the rule dries up, the half-open probe re-admitted r2: the
    # last requests still complete and nothing was dropped
    assert counters["dropped"] == 0
    assert all(e[0] == "fleet_probe" for e in events) and len(events) == 3


def test_forward_faults_are_retried_on_other_replicas():
    outcomes, events, counters = assert_twice_identical("forward_faults")
    assert all(o[0] == "ok" for o in outcomes)
    assert counters["retried"] == 2
    assert counters["failed"] == 0
    assert [e[0] for e in events] == ["fleet_forward", "fleet_forward"]


def test_rolling_deploy_under_load_drops_nothing():
    outcomes, events, counters = assert_twice_identical("rolling_deploy")
    deploys = [o for o in outcomes if o[0] == "deploy"]
    assert deploys == [("deploy", True, 0)]   # converged, zero dropped
    assert all(o[0] in ("ok", "deploy") for o in outcomes)
    assert counters["failed"] == counters["dropped"] == 0


def test_fleet_wide_outage_fails_typed_then_recovers():
    # every probe fails twice: the whole fleet ejects, requests fail
    # *typed* (FleetNoHealthyReplica), and the half-open breakers
    # re-admit replicas so later requests complete
    outcomes, events, counters = assert_twice_identical("fleet_outage")
    assert all(o[0] in ("ok", "FleetNoHealthyReplica") for o in outcomes)
    assert counters["ejections"] == 3
    assert outcomes[-1][0] == "ok"   # the fleet came back
    assert counters["dropped"] == 0


def test_compound_storm_every_request_settles():
    outcomes, events, counters = assert_twice_identical("compound_storm")
    # no hung futures, no silent losses: every request settled, and the
    # surviving capacity completed them all
    assert len([o for o in outcomes if o[0] == "ok"]) \
        + counters["failed"] == 16
    assert counters["dropped"] == 0
    assert len(events) == 4


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_chaos_matrix_matches_jax(scenario):
    """Same seed, same stub replicas: the port's router and the JAX
    package's make the same decisions.  Outcomes, injection log, router
    counters and ``mxnet_fleet_*`` counter series: all EQUAL."""
    port = run_fleet_scenario(PORT, **SCENARIOS[scenario])
    ref = run_fleet_scenario(JAX, **SCENARIOS[scenario])
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3] and port[3]["mxnet_fleet_requests_total"]


# -- the fleet over a real model, against the JAX package ----------------

SMALL = dict(num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             units=64, hidden_size=128, vocab_size=512, page_size=4,
             num_pages=32, max_pages_per_seq=8, max_batch=3,
             prefill_buckets=(8, 16), spec_k=2, prefill_chunk=4,
             paged_kernel="0")
PROMPTS = [[3, 1, 4, 1, 5], [2], list(range(7, 27)), [9] * 11, [5, 6] * 3]


@pytest.fixture(scope="module")
def raw():
    mx.random.seed(3)
    net = llama_small()
    net.initialize()
    net(nd.array(np.zeros((1, 4), np.int32)))   # resolve deferred shapes
    return jm.extract_weights(net)


def _jax_greedy(raw, g):
    """Greedy tokens of the JAX package's server over live-jitted step
    functions, stepped on the calling thread."""
    import jax

    def dev(a):
        return jax.device_put(np.asarray(a, dtype="float32"))

    w = (dev(raw[0]), [{k: dev(v) for k, v in lw.items()} for lw in raw[1]],
         dev(raw[2]), None if raw[3] is None else dev(raw[3]))
    fns = {"decode": jax.jit(jm.build_decode_fn(w, g)),
           "verify": jax.jit(jm.build_verify_fn(w, g)),
           "chunk": jax.jit(jm.build_step_fn(w, g, g.prefill_chunk))}
    for b in g.prefill_buckets:
        fns["prefill_%d" % b] = jax.jit(jm.build_prefill_fn(w, g, b))
    arena = jserve.PagedKVArena(g)
    srv = jserve.LlamaServer.from_parts(jserve.AOTRunner(fns, arena), arena,
                                        clock=counter_clock())
    reqs = [srv.scheduler.submit(jserve.Request(p, max_new_tokens=6))
            for p in PROMPTS]
    while srv.scheduler.has_work():
        srv._loop_tick()
    srv.scheduler.release_shared()
    srv.arena.assert_quiescent()
    return [r.result(timeout=0) for r in reqs]


def test_fleet_greedy_tokens_over_llama_small_match_jax(raw):
    want = _jax_greedy(raw, jm.KVGeometry(**SMALL))
    servers = []
    for _ in range(2):
        arena = PagedKVArena(KVGeometry(**SMALL), device="cpu")
        w = serve.convert_weights(raw, "float32", "cpu")
        servers.append(LlamaServer.from_parts(TorchRunner(w, arena),
                                              arena).start())
    router = FleetRouter(servers, probe_interval=0, seed=0)
    try:
        router.start(poller=False)
        futs = [router.submit(p, max_new_tokens=6, timeout=120)
                for p in PROMPTS]
        assert [f.result(timeout=120) for f in futs] == want
        assert {f.replica for f in futs} == set(router._states)
    finally:
        router.stop()
        for srv in servers:
            srv.drain(timeout=30)
            srv.stop()
            srv.arena.assert_quiescent()


# -- the fleet over real port bundles -------------------------------------

BUNDLE_GEOMETRY = dict(TINY, num_layers=2, num_pages=24, max_pages_per_seq=6,
                       max_batch=3, spec_k=2)


def _save_bundle(path, seed):
    g = KVGeometry(**BUNDLE_GEOMETRY)
    w = serve.init_weights(g, seed=seed, std=0.5, device="cpu")
    raw = (w[0].numpy(), [{k: v.numpy() for k, v in lw.items()}
                          for lw in w[1]], w[2].numpy(),
           None if w[3] is None else w[3].numpy())
    serve.save_serving_bundle(path, raw, g)
    return path


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_bundles")
    return (_save_bundle(str(d / "a.npz"), 4),
            _save_bundle(str(d / "b.npz"), 5))


def _greedy_alone(path, prompts, n):
    with LlamaServer(path, device="cpu") as srv:
        return [srv.generate(p, max_new_tokens=n) for p in prompts]


def _stop_fleet(router, servers):
    router.stop()
    for srv in servers:
        srv.drain(timeout=30)
        srv.stop()
        srv.arena.assert_quiescent()


def test_fleet_routes_port_bundles_with_greedy_parity_and_shared_sha(
        bundles):
    path = bundles[0]
    prompts = [[3, 1, 4], [2, 7], [5]]
    want = _greedy_alone(path, prompts, 5)
    servers = [LlamaServer(path, device="cpu").start() for _ in range(2)]
    router = FleetRouter(servers, probe_interval=0, seed=0)
    try:
        router.start(poller=False)
        assert [router.generate(p, max_new_tokens=5, timeout=120)
                for p in prompts] == want
        body = router.healthz()
        shas = {st["bundle_sha"] for st in body["replicas"].values()}
        assert len(shas) == 1 and None not in shas   # one bundle, fleetwide
        assert body["replicas_healthy"] == 2
    finally:
        _stop_fleet(router, servers)


def test_fleet_rolling_deploy_port_bundles_mid_stream(bundles):
    path_a, path_b = bundles
    rs = np.random.default_rng(6)
    prompts = [rs.integers(1, 32, size=int(n)).tolist()
               for n in rs.integers(1, 7, size=8)]
    want_a = _greedy_alone(path_a, prompts, 6)
    want_b = _greedy_alone(path_b, prompts, 6)
    servers = [LlamaServer(path_a, device="cpu").start() for _ in range(2)]
    router = FleetRouter(servers, probe_interval=0, seed=0)
    try:
        router.start(poller=False)
        inflight = [router.submit(p, max_new_tokens=6, timeout=120)
                    for p in prompts]
        report = router.rolling_deploy(path_b, timeout=120)
        assert report["converged"] and report["dropped"] == 0
        # in-flight work settled, some on A's weights (pre-swap), the
        # rest routed around the deploy, but NOTHING was dropped
        outs = [f.result(timeout=120) for f in inflight]
        for o, a, b in zip(outs, want_a, want_b):
            assert o in (a, b)
        # post-deploy traffic runs on bundle B's weights everywhere
        for p, b in list(zip(prompts, want_b))[:3]:
            assert router.generate(p, max_new_tokens=6, timeout=120) == b
    finally:
        _stop_fleet(router, servers)


def test_fleet_cli_serves_then_drains_on_sigterm(bundles):
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "mxnet_tpu_torch.serve",
         "--bundle", bundles[0], "--port", "0", "--fleet", "2",
         "--device", "cpu", "--drain-timeout", "10"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving fleet n=2" in line, line
        base = line.split(" on ")[1].split()[0]
        out = _post(base, {"prompt": [3, 1, 4], "max_new_tokens": 4},
                    timeout=60)
        assert out["tokens"] == _greedy_alone(bundles[0], [[3, 1, 4]], 4)[0]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
