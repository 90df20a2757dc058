"""The port's fleet observability plane on the CPU: cross-replica
tracing, fleet-wide metric aggregation (``telemetry.aggregate``), the
SLO / error-budget engine (``telemetry.slo``), trace merging
(``telemetry.merge_traces``) and the ``tools/torch_mx*`` command lines
over the port's flight dumps.

The first part is the port's copy of the JAX package's
``tests/test_fleet_obs.py``, on ``from_parts`` servers with the
deterministic stub runner of ``test_torch_fleet``; then the
``merge_traces`` and flight-tool cases of ``tests/test_telemetry.py``
and ``tests/test_flight.py``.

Parity with the JAX package, with the tolerance of each:

- aggregation: the same seeded metric snapshots through both packages'
  ``merge_snapshots``, ``overlay`` and ``snapshot_from_stats`` give
  EQUAL documents;
- the SLO engine: the same scripted counter and histogram stream, on the
  same injected clock, gives EQUAL ``observe`` results at every step and
  EQUAL ``slo.burn``/``slo.clear`` alert sequences.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_fleet import make_fleet, make_server, shutdown

from mxnet_tpu.telemetry import aggregate as jaggregate
from mxnet_tpu.telemetry import flight as jflight
from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.fleet import FleetRouter, HttpReplica
from mxnet_tpu_torch.telemetry import aggregate, flight, slo
from mxnet_tpu_torch.telemetry.aggregate import (merge_snapshots, overlay,
                                                 snapshot_from_stats)
from mxnet_tpu_torch.telemetry.slo import (SLOEngine, default_objectives,
                                           parse_objectives)
from mxnet_tpu_torch.testing import faults
from mxnet_tpu_torch.testing.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    """Load ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name + "_under_test", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    flight.reset()
    yield
    faults.uninstall()
    telemetry.reset()
    flight.reset()


def _ev(kind):
    """Flight events of one kind with the volatile fields stripped."""
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in flight.events(kind=kind)]


# -- distributed tracing: in-process -------------------------------------

def test_fleet_trace_id_minted_and_stamped_into_replica():
    servers, router = make_fleet(2)
    try:
        fut = router.submit([1, 2, 3], max_new_tokens=2, timeout=30)
        fut.result(timeout=30)
        tid = fut.trace_id
        assert tid and tid.startswith("f")
        # the SAME id reached the winning replica's scheduler
        tr = router.trace(tid)
        assert tr is not None
        assert tr["fleet"]["status"] == "ok"
        assert tr["fleet"]["queue_at_router_s"] is not None
        assert tr["replica"] == fut.replica
        assert tr["replica_trace"]["trace_id"] == tid
        assert tr["replica_trace"]["status"] == "completed"
        # fleet.submit / fleet.attempt / fleet.request all carry it
        assert any(e["tid"] == tid for e in _ev("fleet.submit"))
        att = [e for e in _ev("fleet.attempt") if e["tid"] == tid]
        assert att and att[0]["replica"] == fut.replica
        assert att[0]["role"] == "primary" and att[0]["outcome"] == "ok"
        assert att[0]["attempt"] == 0 and att[0]["dur_s"] > 0
        req = [e for e in _ev("fleet.request") if e["tid"] == tid]
        assert req and req[0]["status"] == "ok"
        assert req[0]["winner"] == fut.replica
    finally:
        shutdown(router, servers)


def test_fleet_trace_ids_unique_and_store_bounded():
    servers, router = make_fleet(1)
    try:
        router._trace_cap = 4
        tids = [router.generate([1 + i], max_new_tokens=1, timeout=30)
                and flight.events(kind="fleet.submit")[-1]["tid"]
                for i in range(6)]
        assert len(set(tids)) == 6
        assert len(router._rtraces) == 4          # FIFO-capped
        assert router.trace(tids[0]) is None      # evicted
        assert router.trace(tids[-1]) is not None
    finally:
        shutdown(router, servers)


def test_retry_attempts_share_trace_id_with_attribution():
    from mxnet_tpu_torch.serve import ServeQueueFull
    servers, router = make_fleet(2)
    try:
        sched0 = servers[0].scheduler
        real_submit = sched0.submit

        def full_submit(req):
            err = ServeQueueFull("queue full (test)")
            err.retry_after_s = 0.01
            raise err

        sched0.submit = full_submit
        try:
            for i in range(4):    # one lands on r0 and gets retried
                router.generate([2 + i], max_new_tokens=1, timeout=30)
        finally:
            sched0.submit = real_submit
        assert router.retried >= 1
        retries = _ev("fleet.retry")
        assert retries and all(e.get("tid") for e in retries)
        tid = retries[0]["tid"]
        # the retried request's attempts: same tid, increasing attempt
        att = [e for e in _ev("fleet.attempt") if e["tid"] == tid]
        assert [a["attempt"] for a in att] == list(range(len(att)))
        assert att[-1]["outcome"] == "ok"
        assert {a["replica"] for a in att} == {"r0", "r1"}
        tr = router.trace(tid)["fleet"]
        assert tr["status"] == "ok" and len(tr["attempts"]) == len(att)
    finally:
        shutdown(router, servers)


def test_hedged_request_attempt_spans_and_loser_cancellation():
    servers, router = make_fleet(
        2, router_kw=dict(hedge=True, hedge_delay_s=0.01))
    try:
        faults.install(FaultPlan(seed=1337, rules=[
            {"site": "replica_hang", "action": "raise",
             "match": {"replica": "r0"}, "times": 1}]))
        for i in range(4):   # one of these lands on r0 and hangs
            router.generate([2 + i], max_new_tokens=2, timeout=20)
        faults.uninstall()
        assert router.hedged >= 1
        hedges = _ev("fleet.hedge")
        assert hedges and hedges[0]["tid"]
        tid = hedges[0]["tid"]
        assert hedges[0]["delay_s"] == pytest.approx(0.01)
        # both attempts carry the SAME fleet trace id, attributed by
        # role, and the losing primary's cancellation is an event
        att = [e for e in _ev("fleet.attempt") if e["tid"] == tid]
        roles = {a["role"]: a for a in att}
        assert set(roles) == {"primary", "hedge"}
        assert roles["hedge"]["outcome"] == "ok"
        assert roles["primary"]["outcome"] == "lost_to_hedge"
        cancels = [e for e in _ev("fleet.cancel") if e["tid"] == tid]
        assert cancels and cancels[0]["replica"] == \
            roles["primary"]["replica"]
        assert cancels[0]["role"] == "primary"
        # the routing breakdown records the hedge fire time
        tr = router.trace(tid)["fleet"]
        assert tr["hedge"]["delay_s"] == pytest.approx(0.01)
        assert tr["hedge"]["t"] >= 0.01
        assert len(tr["attempts"]) == 2
    finally:
        shutdown(router, servers)


# -- distributed tracing: merged chrome timeline -------------------------

def test_mxtrace_merge_renders_hedged_request_across_two_replica_rows(
        tmp_path):
    mxtrace = _tool("torch_mxtrace")
    servers, router = make_fleet(
        2, router_kw=dict(hedge=True, hedge_delay_s=0.01))
    try:
        faults.install(FaultPlan(seed=1337, rules=[
            {"site": "replica_hang", "action": "raise",
             "match": {"replica": "r0"}, "times": 1}]))
        for i in range(4):
            router.generate([2 + i], max_new_tokens=2, timeout=20)
        faults.uninstall()
        tid = flight.events(kind="fleet.hedge")[0]["tid"]
        dump = tmp_path / "router_flight.json"
        flight.dump(str(dump))
        out = tmp_path / "merged.json"
        rc = mxtrace.main(["merge", str(dump), "-o", str(out),
                           "--labels", "router"])
        assert rc == 0
        merged = json.loads(out.read_text())
        spans = [e for e in merged["traceEvents"]
                 if e.get("ph") == "X"
                 and e.get("args", {}).get("tid") == tid]
        att = [s for s in spans if s["name"] == "fleet.attempt"]
        # ONE hedged request = spans on TWO distinct replica rows...
        assert len({s["tid"] for s in att}) == 2
        assert {s["args"]["role"] for s in att} == {"primary", "hedge"}
        # ...under the router's own request span on row 0
        req = [s for s in spans if s["name"] == "fleet.request"]
        assert req and req[0]["tid"] == 0
        assert req[0]["dur"] >= max(s["dur"] for s in att) * 0.9
    finally:
        shutdown(router, servers)


def test_mxflight_show_trace_slices_one_request(tmp_path):
    mxflight = _tool("torch_mxflight")
    servers, router = make_fleet(2)
    try:
        for i in range(3):
            router.generate([1 + i], max_new_tokens=1, timeout=30)
        tids = [e["tid"] for e in flight.events(kind="fleet.submit")]
        dump = tmp_path / "flight.json"
        flight.dump(str(dump))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mxflight.main(["show", str(dump), "--trace", tids[1]])
        assert rc == 0
        out = buf.getvalue()
        assert tids[1] in out
        for other in (tids[0], tids[2]):
            assert other not in out
    finally:
        shutdown(router, servers)


# -- distributed tracing: HTTP header propagation ------------------------

def test_http_replica_propagates_trace_header_and_fleet_trace_proxies():
    srvs = [make_server() for _ in range(2)]
    urls = []
    for s in srvs:
        h, p = s.serve_http(port=0)
        urls.append("http://%s:%d" % (h, p))
    reps = [HttpReplica(u, name="h%d" % i) for i, u in enumerate(urls)]
    router = FleetRouter(reps, probe_interval=0, retries=2,
                         backoff_s=0.001, seed=0, sleep=lambda s: None)
    router.start(poller=False)
    fh, fp = router.serve_http(port=0)
    base = "http://%s:%d" % (fh, fp)
    try:
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"prompt": [1, 2],
                             "max_new_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        tid = out["trace_id"]
        assert tid.startswith("f")
        # the fleet id crossed the wire (X-MXNet-Trace) into the
        # replica's scheduler, so the fleet trace endpoint can stitch
        # the routing breakdown onto the owning replica's trace
        with urllib.request.urlopen(base + "/v1/trace/" + tid,
                                    timeout=10) as r:
            tr = json.loads(r.read())
        assert tr["fleet"]["status"] == "ok"
        assert tr["replica"] == out["replica"]
        assert tr["replica_trace"]["trace_id"] == tid
        assert tr["replica_trace"]["status"] == "completed"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/v1/trace/f-nope", timeout=10)
        assert ei.value.code == 404
    finally:
        router.stop()
        for s in srvs:
            s.drain(timeout=10)
            s.stop()


# -- fleet metric aggregation: pure merge semantics ----------------------

def test_merge_snapshots_counters_sum_per_labelset():
    a = {"reqs_total": {"type": "counter", "help": "h", "series": [
        {"labels": {"status": "ok"}, "value": 3},
        {"labels": {"status": "error"}, "value": 1}]}}
    b = {"reqs_total": {"type": "counter", "help": "h", "series": [
        {"labels": {"status": "ok"}, "value": 4}]}}
    m = merge_snapshots({"r1": b, "r0": a})
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in m["reqs_total"]["series"]}
    assert series[(("status", "ok"),)] == 7
    assert series[(("status", "error"),)] == 1


def test_merge_snapshots_gauges_keep_per_replica_series():
    a = {"queue": {"type": "gauge", "help": "h",
                   "series": [{"labels": {}, "value": 5}]}}
    b = {"queue": {"type": "gauge", "help": "h",
                   "series": [{"labels": {}, "value": 2}]}}
    m = merge_snapshots({"r0": a, "r1": b})
    series = {s["labels"]["replica"]: s["value"]
              for s in m["queue"]["series"]}
    assert series == {"r0": 5, "r1": 2}


def test_merge_snapshots_histograms_merge_bucketwise():
    def h(buckets, s, c):
        return {"lat": {"type": "histogram", "help": "h", "series": [
            {"labels": {}, "buckets": buckets, "sum": s, "count": c}]}}
    m = merge_snapshots({
        "r0": h({"0.1": 1, "1": 3, "+Inf": 4}, 2.0, 4),
        "r1": h({"0.1": 2, "1": 2, "+Inf": 2}, 0.5, 2)})
    s = m["lat"]["series"][0]
    assert s["buckets"] == {"0.1": 3, "1": 5, "+Inf": 6}
    assert s["sum"] == pytest.approx(2.5) and s["count"] == 6
    # cumulative-bucket order survives, +Inf last
    assert list(s["buckets"]) == ["0.1", "1", "+Inf"]
    # the merged series is quantile-able fleet-wide
    from mxnet_tpu_torch.telemetry.metrics import histogram_quantile
    assert histogram_quantile(s, 0.5) <= 1.0


def test_merge_snapshots_deterministic_in_scrape_order():
    a = {"g": {"type": "gauge", "help": "", "series":
               [{"labels": {}, "value": 1}]}}
    b = {"g": {"type": "gauge", "help": "", "series":
               [{"labels": {}, "value": 2}]}}
    assert merge_snapshots({"r0": a, "r1": b}) == \
        merge_snapshots({"r1": b, "r0": a})


def test_overlay_merged_families_win_local_fills_gaps():
    merged = {"shared": {"type": "counter", "help": "", "series":
                         [{"labels": {}, "value": 10}]}}
    local = {"shared": {"type": "counter", "help": "", "series":
                        [{"labels": {}, "value": 99}]},
             "router_only": {"type": "gauge", "help": "", "series": []}}
    out = overlay(merged, local)
    assert out["shared"]["series"][0]["value"] == 10   # no double count
    assert "router_only" in out


def test_snapshot_from_stats_skips_missing_keys():
    snap = snapshot_from_stats({"queue_len": 3, "admitted": 7})
    assert snap["mxnet_serve_queue_depth"]["type"] == "gauge"
    assert snap["mxnet_serve_queue_depth"]["series"][0]["value"] == 3
    assert snap["mxnet_serve_replica_admitted_total"]["type"] == "counter"
    assert "mxnet_serve_arena_utilization" not in snap   # not zeroed


# -- fleet metric aggregation: live fleet --------------------------------

def test_fleet_metrics_endpoint_carries_all_replica_labels():
    servers, router = make_fleet(3)
    host, port = router.serve_http(port=0)
    base = "http://%s:%d" % (host, port)
    try:
        for i in range(3):
            router.generate([1 + i], max_new_tokens=1, timeout=30)
        router.probe_all(metrics=True)
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        for name in ("r0", "r1", "r2"):
            assert 'replica="%s"' % name in text
        # gauges are per replica; the synthesized counters merged
        depth_lines = [l for l in text.splitlines()
                       if l.startswith("mxnet_serve_queue_depth{")]
        assert len(depth_lines) == 3
        assert "mxnet_serve_replica_completed_total" in text
        # router families overlaid, not double-counted
        assert "mxnet_fleet_requests_total" in text
        # the JSON twin serves the same aggregated snapshot
        with urllib.request.urlopen(base + "/metrics.json",
                                    timeout=10) as r:
            snap = json.loads(r.read())
        got = {s["labels"]["replica"] for s in
               snap["mxnet_serve_queue_depth"]["series"]}
        assert got == {"r0", "r1", "r2"}
        comp = snap["mxnet_serve_replica_completed_total"]["series"]
        assert comp[0]["value"] == 3
    finally:
        shutdown(router, servers)


def test_metrics_scrape_cadence_is_lower_than_probe_cadence():
    servers, router = make_fleet(1, router_kw=dict(probe_interval=0))
    try:
        router.metrics_every = 4
        st = router._states["r0"]
        base_probes = st.probes
        t_first = None
        for i in range(8):
            router.probe_all()
            if t_first is None:
                t_first = st.metrics_t
        assert st.probes == base_probes + 8
        # first probe scraped (cold), then every 4th: 8 probes ~ 2-3
        # scrapes, strictly fewer than probes
        assert st.metrics_snap is not None
        assert st.metrics_t >= t_first
    finally:
        shutdown(router, servers)


def test_concurrent_scrape_under_load_counters_exact():
    """Scrape/aggregate while 3 in-process replicas serve the seeded
    64-request workload: no torn reads — the merged completed counter
    is monotonic across scrapes and lands exactly on 64."""
    servers, router = make_fleet(3)
    try:
        stop = threading.Event()
        seen = []
        errs = []

        def scraper():
            while not stop.is_set():
                try:
                    router.probe_all(metrics=True)
                    snap = router.fleet_metrics_snapshot()
                    fam = snap.get("mxnet_serve_replica_completed_total")
                    if fam:
                        seen.append(sum(s["value"]
                                        for s in fam["series"]))
                except Exception as e:  # noqa: BLE001 — fail the test
                    errs.append(e)
                    return

        th = threading.Thread(target=scraper, daemon=True)
        th.start()
        done = []

        def worker(base):
            for i in range(16):
                router.generate([1 + (base + i) % 30],
                                max_new_tokens=2, timeout=60)
            done.append(base)

        workers = [threading.Thread(target=worker, args=(b,),
                                    daemon=True) for b in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        stop.set()
        th.join(timeout=30)
        assert not errs, errs
        assert len(done) == 4
        assert seen == sorted(seen)      # counters never run backwards
        router.probe_all(metrics=True)
        snap = router.fleet_metrics_snapshot()
        total = sum(s["value"] for s in
                    snap["mxnet_serve_replica_completed_total"]["series"])
        assert total == 64
        admitted = sum(s["value"] for s in
                       snap["mxnet_serve_replica_admitted_total"]
                       ["series"])
        assert admitted == 64
    finally:
        shutdown(router, servers)


def test_healthz_reports_tpot_and_arena_per_replica():
    servers, router = make_fleet(2)
    try:
        router.generate([1, 2], max_new_tokens=2, timeout=30)
        router.probe_all()
        body = router.healthz()
        for name in ("r0", "r1"):
            row = body["replicas"][name]
            assert "tpot_p50_s" in row
            assert "arena_utilization" in row
            assert 0.0 <= row["arena_utilization"] <= 1.0
    finally:
        shutdown(router, servers)


def test_mxfleet_top_once_renders_fleet_frame():
    mxfleet = _tool("torch_mxfleet")
    servers, router = make_fleet(2)
    host, port = router.serve_http(port=0)
    try:
        router.generate([1, 2], max_new_tokens=1, timeout=30)
        router.probe_all()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mxfleet.main(["top", "--router",
                               "http://%s:%d" % (host, port), "--once"])
        out = buf.getvalue()
        assert rc == 0
        assert "fleet: 2/2 healthy" in out
        for col in ("replica", "state", "queue", "inflight", "tpot",
                    "arena", "failures"):
            assert col in out
        assert "r0" in out and "r1" in out
    finally:
        shutdown(router, servers)


# -- SLO engine ----------------------------------------------------------

def _avail_snap(ok, bad):
    return {"mxnet_fleet_requests_total": {
        "type": "counter", "help": "", "series": [
            {"labels": {"status": "ok"}, "value": ok},
            {"labels": {"status": "error"}, "value": bad}]}}


def _avail_objective():
    return [{"name": "availability", "objective": 0.99,
             "family": "mxnet_fleet_requests_total",
             "good_label": ["status", "ok"]}]


def test_parse_objectives_forms(tmp_path):
    assert parse_objectives("") == []
    assert parse_objectives("1") == default_objectives()
    inline = json.dumps(_avail_objective())
    assert parse_objectives(inline)[0]["name"] == "availability"
    p = tmp_path / "slo.json"
    p.write_text(inline)
    assert parse_objectives(str(p))[0]["name"] == "availability"


def test_slo_engine_validates_objectives():
    with pytest.raises(MXNetError, match="needs 'name' and 'family'"):
        SLOEngine(objectives=[{"objective": 0.99}])
    with pytest.raises(MXNetError, match="must be in"):
        SLOEngine(objectives=[{"name": "x", "family": "f",
                               "objective": 1.0}])


def test_slo_idle_fleet_never_burns():
    t = [0.0]
    eng = SLOEngine(objectives=_avail_objective(), clock=lambda: t[0])
    for _ in range(20):
        t[0] += 10.0
        out = eng.observe(_avail_snap(100, 0))   # no new events
    assert out["availability"]["burn_fast"] == 0.0
    assert not eng.burning()
    assert _ev("slo.burn") == []


def test_slo_burn_alert_fires_once_run_twice_identical():
    def run():
        telemetry.reset()
        flight.reset()
        t = [0.0]
        eng = SLOEngine(objectives=_avail_objective(),
                        fast_window_s=60.0, slow_window_s=600.0,
                        clock=lambda: t[0])
        ok = bad = 0
        for step in range(100):
            t[0] += 10.0
            if 30 <= step < 50:        # seeded outage: 50% errors
                ok += 5
                bad += 5
            else:
                ok += 10
            eng.observe(_avail_snap(ok, bad))
        return _ev("slo.burn"), _ev("slo.clear")

    burns_a, clears_a = run()
    burns_b, clears_b = run()
    assert (burns_a, clears_a) == (burns_b, clears_b)
    assert len(burns_a) == 1           # edge-triggered: exactly one
    assert burns_a[0]["slo"] == "availability"
    assert burns_a[0]["burn_fast"] >= 2.0
    assert len(clears_a) == 1          # and one clear when it ends
    # counted and gauged
    snap = telemetry.snapshot()
    ev = snap["mxnet_slo_burn_events_total"]["series"][0]
    assert ev["value"] == 1
    assert snap["mxnet_slo_burning"]["series"][0]["value"] == 0
    assert "mxnet_slo_error_budget_remaining" in snap


def test_slo_latency_objective_reads_cumulative_buckets():
    eng = SLOEngine(objectives=[
        {"name": "ttft_p99", "objective": 0.99,
         "family": "mxnet_serve_ttft_seconds", "threshold_s": 0.5}],
        clock=lambda: 0.0)

    def snap(under, total):
        return {"mxnet_serve_ttft_seconds": {
            "type": "histogram", "help": "", "series": [
                {"labels": {}, "buckets": {"0.1": under // 2,
                                           "0.5": under,
                                           "+Inf": total},
                 "sum": 1.0, "count": total}]}}
    t = [0.0]
    eng._clock = lambda: t[0]
    eng.observe(snap(100, 100))
    t[0] += 30.0
    out = eng.observe(snap(110, 140))   # 30 slow of 40 new: burning
    bf = out["ttft_p99"]["burn_fast"]
    assert bf == pytest.approx((30 / 40) / 0.01)
    # threshold above the bucket ladder: everything counts as good
    # (a coarse ladder rounds the threshold up, never drops data)
    from mxnet_tpu_torch.telemetry.slo import _good_total
    assert _good_total(
        {"name": "x", "objective": 0.99,
         "family": "mxnet_serve_ttft_seconds", "threshold_s": 99.0},
        snap(10, 40)) == (40, 40)


def test_slo_shed_disables_hedging_until_all_clear():
    servers, router = make_fleet(
        2, router_kw=dict(hedge=True, hedge_delay_s=0.01))
    try:
        t = [0.0]
        eng = SLOEngine(objectives=_avail_objective(),
                        fast_window_s=60.0, slow_window_s=600.0,
                        clock=lambda: t[0])
        router.attach_slo(eng, shed=True)
        assert router.hedge is True
        ok = bad = 0
        # drive an outage through the engine directly (the prober would
        # feed aggregated snapshots the same way)
        for step in range(60):
            t[0] += 10.0
            if step >= 30:
                ok += 5
                bad += 5
            else:
                ok += 10
            eng.observe(_avail_snap(ok, bad))
            if eng.burning():
                break
        assert eng.burning()
        assert router.hedge is False          # optional work shed first
        assert router._hedge_saved is True
        sheds = _ev("fleet.shed")
        assert sheds and sheds[0]["shedding"] is True
        # recovery: errors stop, fast window drains, alert clears
        for _ in range(40):
            t[0] += 10.0
            ok += 10
            eng.observe(_avail_snap(ok, bad))
            if not eng.burning():
                break
        assert not eng.burning()
        assert router.hedge is True           # restored on all-clear
        assert _ev("fleet.shed")[-1]["shedding"] is False
    finally:
        shutdown(router, servers)


def test_router_slo_tick_feeds_engine_and_healthz_surfaces_state():
    servers, router = make_fleet(2)
    try:
        t = [0.0]
        eng = SLOEngine(objectives=_avail_objective(),
                        clock=lambda: t[0])
        router.attach_slo(eng)
        router.generate([1, 2], max_new_tokens=1, timeout=30)
        router.probe_all()                    # tick observes aggregate
        assert len(eng._samples) >= 1
        body = router.healthz()
        assert body["slo"] == {"burning": [], "shedding": False}
        snap = telemetry.snapshot()
        assert "mxnet_slo_burn_rate" in snap
    finally:
        shutdown(router, servers)


def test_router_start_attaches_slo_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_FLEET_SLO", "1")
    servers, router = make_fleet(2, start_router=False)
    try:
        router.start(poller=False)
        assert router._slo is not None
        assert [o["name"] for o in router._slo.objectives] == \
            ["availability", "ttft_p99", "tpot_p50"]
    finally:
        shutdown(router, servers)


# -- trace merging and the flight tools ------------------------------------

def test_merge_traces_aligns_and_remaps(tmp_path):
    w = {"traceEvents": [
        {"name": "kv_push", "ph": "X", "ts": 100.0, "dur": 50.0,
         "pid": 0, "tid": 1}],
        "otherData": {"wall_t0_us": 1_000_000.0}}
    s = {"traceEvents": [
        {"name": "KVStoreServer::push", "ph": "X", "ts": 10.0,
         "dur": 20.0, "pid": 1, "tid": 1}],
        "otherData": {"wall_t0_us": 1_000_100.0}}
    out = str(tmp_path / "merged.json")
    merged = telemetry.merge_traces([w, s], out=out, labels=["w0", "srv"])
    evs = {e["name"]: e for e in merged["traceEvents"]
           if e.get("ph") == "X"}
    # second trace's anchor is 100us later: its events shift right
    assert evs["kv_push"]["ts"] == 100.0
    assert evs["KVStoreServer::push"]["ts"] == 110.0
    # local events leave pid 0; the server span keeps its recorded pid
    assert evs["kv_push"]["pid"] != 0
    assert evs["KVStoreServer::push"]["pid"] == 1
    assert evs["kv_push"]["pid"] != evs["KVStoreServer::push"]["pid"]
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M"}
    assert "w0" in names and "server:rank0" in names
    with open(out) as f:
        assert json.load(f)["traceEvents"]


def test_merge_traces_accepts_paths_and_bare_lists(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 1.0, "dur": 2.0,
         "pid": 0, "tid": 0}]}))
    merged = telemetry.merge_traces(
        [str(p), [{"name": "b", "ph": "X", "ts": 3.0, "dur": 1.0,
                   "pid": 0, "tid": 0}]])
    names = {e["name"] for e in merged["traceEvents"]
             if e.get("ph") == "X"}
    assert names == {"a", "b"}


def test_torch_mxtrace_cli_merge(tmp_path):
    t1 = tmp_path / "w.json"
    t1.write_text(json.dumps({"traceEvents": [
        {"name": "kv_push", "ph": "X", "ts": 0.0, "dur": 5.0,
         "pid": 0, "tid": 0}],
        "otherData": {"wall_t0_us": 0.0}}))
    out = tmp_path / "merged.json"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_mxtrace.py"),
         "merge", str(t1), "-o", str(out)],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "merged 1 events" in r.stdout
    assert json.loads(out.read_text())["traceEvents"]


def test_torch_mxflight_show_filters(tmp_path, capsys):
    flight.record("kv.send", cmd="push", server=0)
    flight.record("engine.flush", ops=3)
    path = flight.dump(tmp_path / "d.json")
    cli = _tool("torch_mxflight")
    assert cli.main(["show", path, "--kind", "kv", "--last", "5"]) == 0
    out = capsys.readouterr().out
    assert "kv.send" in out and "engine.flush" not in out
    assert "cmd=push" in out


def test_torch_mxflight_merge_aligns_on_one_timeline(tmp_path):
    flight.record("engine.flush", ops=1)
    p0 = flight.dump(tmp_path / "r0.json")
    flight.record("kv.send", cmd="pull", server=1)
    p1 = flight.dump(tmp_path / "r1.json")
    out = tmp_path / "merged.json"
    cli = _tool("torch_mxflight")
    assert cli.main(["merge", p0, p1, "-o", str(out)]) == 0
    with open(out) as f:
        merged = json.load(f)
    names = [e["name"] for e in merged["traceEvents"]
             if e.get("ph") == "i"]
    assert "engine.flush" in names and "kv.send" in names
    # each dump landed on its own process track
    pids = {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "i"}
    assert len(pids) == 2


def test_to_trace_carries_wall_anchor(tmp_path):
    flight.record("t.a")
    doc = flight.load(flight.dump(tmp_path / "a.json"))
    tr = flight.to_trace(doc)
    assert tr["otherData"]["wall_t0_us"] == doc["meta"]["wall_t0_us"]
    (ev,) = [e for e in tr["traceEvents"] if e["name"] == "t.a"]
    assert ev["ph"] == "i" and ev["ts"] >= 0


# -- parity with the JAX package: aggregation and the SLO engine ---------

def _random_snapshot(rs, replica):
    """A snapshot-shaped doc: counters with a status label, a gauge and a
    cumulative histogram, values drawn from ``rs``."""
    bounds = ["0.01", "0.1", "1"]
    counts = np.cumsum(rs.integers(0, 20, size=len(bounds) + 1))
    return {
        "mxnet_fleet_requests_total": {"type": "counter", "help": "h",
                                       "series": [
            {"labels": {"status": st}, "value": int(rs.integers(0, 50))}
            for st in ("ok", "error")[:1 + replica % 2]]},
        "mxnet_serve_queue_depth": {"type": "gauge", "help": "h",
                                    "series": [{"labels": {},
                                                "value": int(rs.integers(
                                                    0, 9))}]},
        "mxnet_serve_ttft_seconds": {"type": "histogram", "help": "h",
                                     "series": [{
            "labels": {}, "sum": float(rs.random() * 10),
            "count": int(counts[-1]),
            "buckets": dict(zip(bounds + ["+Inf"],
                                (int(c) for c in counts)))}]},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregation_matches_jax(seed):
    rs = np.random.default_rng(seed)
    snaps = {"r%d" % i: _random_snapshot(rs, i) for i in range(3)}
    local = _random_snapshot(rs, 0)
    local["router_only"] = {"type": "gauge", "help": "", "series": [
        {"labels": {}, "value": 1}]}
    stats = {"queue_len": 3, "admitted": 7, "completed": 6,
             "arena_utilization": float(rs.random()), "decode_steps": 40}
    for mod in (aggregate, jaggregate):
        assert mod.merge_snapshots(dict(reversed(list(snaps.items())))) \
            == mod.merge_snapshots(snaps)
    merged = merge_snapshots(snaps)
    assert merged == jaggregate.merge_snapshots(snaps)
    assert overlay(merged, local) == jaggregate.overlay(merged, local)
    assert snapshot_from_stats(stats) == \
        jaggregate.snapshot_from_stats(stats)


def _slo_stream(seed):
    """A scripted aggregated stream: availability counters with a seeded
    outage, and TTFT buckets that go slow at the same time."""
    rs = np.random.default_rng(seed)
    ok = bad = under = total = 0
    for step in range(120):
        outage = 40 <= step < 60
        n = int(rs.integers(5, 15))
        b = int(rs.integers(n // 3, n)) if outage else 0
        ok, bad = ok + n - b, bad + b
        slow = b + int(rs.integers(0, 2))
        total += n
        under += max(0, n - slow)
        yield {"mxnet_fleet_requests_total": {
                   "type": "counter", "help": "", "series": [
                       {"labels": {"status": "ok"}, "value": ok},
                       {"labels": {"status": "error"}, "value": bad}]},
               "mxnet_serve_ttft_seconds": {
                   "type": "histogram", "help": "", "series": [
                       {"labels": {}, "sum": 1.0, "count": total,
                        "buckets": {"0.1": under // 2, "0.5": under,
                                    "+Inf": total}}]}}


def _slo_events(fl):
    return [{k: v for k, v in e.items() if k not in ("seq", "ts")}
            for e in fl.events(kind="slo")]


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_engine_matches_jax(seed):
    objectives = [
        {"name": "availability", "objective": 0.99,
         "family": "mxnet_fleet_requests_total",
         "good_label": ["status", "ok"]},
        {"name": "ttft_p99", "objective": 0.99,
         "family": "mxnet_serve_ttft_seconds", "threshold_s": 0.5}]
    runs = []
    for pkg_slo, pkg_flight, pkg_metrics in ((slo, flight, telemetry),
                                             (jslo, jflight, jmetrics)):
        pkg_flight.reset()
        pkg_metrics.reset()
        t = [0.0]
        eng = pkg_slo.SLOEngine(objectives=objectives, fast_window_s=60.0,
                                slow_window_s=600.0, clock=lambda: t[0])
        outs = []
        for snap in _slo_stream(seed):
            t[0] += 10.0
            outs.append(eng.observe(snap))
        runs.append((outs, _slo_events(pkg_flight), eng.burning()))
    assert runs[0] == runs[1]
    burns = [e for e in runs[0][1] if e["kind"] == "slo.burn"]
    assert {e["slo"] for e in burns} == {"availability", "ttft_p99"}
