"""SLO / error-budget engine with multi-window burn-rate alerts
(docs/observability.md "Fleet observability").

An SLO is a target fraction of *good* events — requests that succeeded,
TTFTs under a threshold — over a rolling window.  The error budget is
the allowed bad fraction (``1 - objective``); the **burn rate** is how
fast the fleet is spending it: ``bad_fraction / (1 - objective)``.  A
burn rate of 1.0 exhausts the budget exactly at the window's horizon;
14.4 exhausts a 30-day budget in 2 days — the classic paging threshold.

Objectives are declarative dicts evaluated over the *aggregated* metric
stream (``telemetry.aggregate``), never over a single replica:

* ``availability`` — good/total from a counter family with a status
  label (``{"name": "availability", "objective": 0.99,
  "family": "mxnet_fleet_requests_total",
  "good_label": ["status", "ok"]}``);
* ``latency`` — good = observations at or under ``threshold_s`` read
  from a histogram family's cumulative buckets
  (``{"name": "ttft_p99", "objective": 0.99,
  "family": "mxnet_serve_ttft_seconds", "threshold_s": 0.5}``).

Evaluation is **two-window**: a fast window catches an active outage, a
slow window keeps one bad scrape from paging.  The engine is
edge-triggered — one ``slo.burn`` flight event when an objective
*enters* the burning state, one ``slo.clear`` when it leaves — so a
seeded outage produces exactly one alert, run-twice identical.  State
surfaces as ``mxnet_slo_*`` gauges; an ``on_burn``/``on_clear`` pair
lets the FleetRouter shed optional work (hedging) while the fast window
burns (``MXNET_FLEET_SLO_SHED``).

The engine holds no threads and reads no wall clock of its own: the
caller feeds ``observe(snapshot, now)`` on its own cadence (the fleet
prober does), and an injectable clock keeps the chaos matrix
deterministic.
"""
from __future__ import annotations

import collections
import json
import time

from ..base import MXNetError
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["SLOEngine", "default_objectives", "parse_objectives"]


def default_objectives():
    """The stock fleet objectives (``MXNET_FLEET_SLO=1``): availability
    plus the ROADMAP item 1 latency bars, TTFT p99 and TPOT p50."""
    return [
        {"name": "availability", "objective": 0.99,
         "family": "mxnet_fleet_requests_total",
         "good_label": ["status", "ok"]},
        {"name": "ttft_p99", "objective": 0.99,
         "family": "mxnet_serve_ttft_seconds", "threshold_s": 0.5},
        {"name": "tpot_p50", "objective": 0.50,
         "family": "mxnet_serve_tpot_seconds", "threshold_s": 0.05},
    ]


def parse_objectives(spec):
    """``MXNET_FLEET_SLO`` accepts ``1`` (stock objectives), an inline
    JSON list, or a path to a JSON file holding one."""
    spec = (spec or "").strip()
    if not spec:
        return []
    if spec == "1":
        return default_objectives()
    if spec.startswith("["):
        return json.loads(spec)
    with open(spec) as f:
        return json.load(f)


def _good_total(obj, snapshot):
    """Cumulative (good, total) for one objective from one aggregated
    snapshot; None when the family has no data yet."""
    fam = (snapshot or {}).get(obj["family"])
    if fam is None:
        return None
    series = fam.get("series", [])
    if "threshold_s" in obj:
        # latency: good = observations <= the smallest bucket bound
        # covering threshold_s (conservative: a coarse ladder rounds
        # the threshold UP, never silently relaxes it)
        good = total = 0
        thr = float(obj["threshold_s"])
        for s in series:
            buckets = s.get("buckets", {})
            finite = sorted((float(b), c) for b, c in buckets.items()
                            if b != "+Inf")
            covering = next((c for bound, c in finite if bound >= thr),
                            None)
            if covering is None:    # threshold above the ladder: all good
                covering = s.get("count", 0)
            good += covering
            total += s.get("count", 0)
        return (good, total)
    key, val = obj.get("good_label", ["status", "ok"])
    good = sum(s.get("value", 0) for s in series
               if str(s.get("labels", {}).get(key)) == str(val))
    total = sum(s.get("value", 0) for s in series)
    return (good, total)


class SLOEngine:
    """Evaluates declarative objectives over aggregated snapshots; see
    the module docstring.  Thread-compatible, not thread-safe: one
    caller (the fleet prober) owns ``observe``."""

    def __init__(self, objectives=None, fast_window_s=60.0,
                 slow_window_s=600.0, burn_threshold=2.0,
                 clock=time.monotonic, on_burn=None, on_clear=None):
        if objectives is None:
            objectives = default_objectives()
        elif isinstance(objectives, str):
            objectives = parse_objectives(objectives)
        self.objectives = []
        for obj in objectives:
            obj = dict(obj)
            if "name" not in obj or "family" not in obj:
                raise MXNetError(
                    "SLO objective needs 'name' and 'family': %r" % (obj,))
            target = float(obj.get("objective", 0.99))
            if not 0.0 < target < 1.0:
                raise MXNetError(
                    "SLO objective %r must be in (0, 1), got %r"
                    % (obj["name"], target))
            obj["objective"] = target
            self.objectives.append(obj)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._on_burn = on_burn
        self._on_clear = on_clear
        # (t, {name: (good, total)}) cumulative samples, slow-window deep
        self._samples = collections.deque()
        self._burning = {o["name"]: False for o in self.objectives}

    def burning(self, name=None):
        """Is ``name`` (or, with no argument, anything) burning?"""
        if name is not None:
            return self._burning.get(name, False)
        return any(self._burning.values())

    @staticmethod
    def _burn(new, old, objective):
        """Burn rate over the delta between two cumulative samples;
        0.0 when no events landed in the window (no news is good news —
        an idle fleet must not page)."""
        if new is None or old is None:
            return 0.0
        d_total = new[1] - old[1]
        if d_total <= 0:
            return 0.0
        d_bad = d_total - (new[0] - old[0])
        return (d_bad / d_total) / (1.0 - objective)

    def _window_base(self, now, window_s):
        """Newest sample at or older than the window start — the
        comparison base for the cumulative delta.  Falls back to the
        oldest retained sample while history is still shorter than the
        window (a young engine burns on what it has seen)."""
        base = None
        for t, vals in self._samples:
            if t <= now - window_s:
                base = vals
            else:
                break
        if base is None and self._samples:
            base = self._samples[0][1]
        return base

    def observe(self, snapshot, now=None):
        """Feed one aggregated snapshot; returns
        ``{name: {"burn_fast", "burn_slow", "burning",
        "budget_remaining"}}`` and fires the edge-triggered events."""
        now = self._clock() if now is None else now
        current = {o["name"]: _good_total(o, snapshot)
                   for o in self.objectives}
        fast_base = self._window_base(now, self.fast_window_s)
        slow_base = self._window_base(now, self.slow_window_s)
        self._samples.append((now, current))
        while self._samples and \
                self._samples[0][0] < now - self.slow_window_s:
            self._samples.popleft()
        out = {}
        for obj in self.objectives:
            name, target = obj["name"], obj["objective"]
            burn_fast = self._burn(
                current[name],
                fast_base.get(name) if fast_base else None, target)
            burn_slow = self._burn(
                current[name],
                slow_base.get(name) if slow_base else None, target)
            # budget remaining over the slow window: burn 1.0 for the
            # whole window spends it all
            remaining = max(0.0, 1.0 - burn_slow)
            # page on the fast window, but only while the slow window
            # confirms real spend — one bad scrape against an idle slow
            # window must not flap the alert
            burning = (burn_fast >= self.burn_threshold
                       and burn_slow >= 1.0)
            self._export(name, burn_fast, burn_slow, burning, remaining)
            if burning != self._burning[name]:
                self._burning[name] = burning
                self._edge(name, burning, burn_fast, burn_slow)
            out[name] = {"burn_fast": burn_fast, "burn_slow": burn_slow,
                         "burning": burning,
                         "budget_remaining": remaining}
        return out

    def _export(self, name, burn_fast, burn_slow, burning, remaining):
        if not _metrics.enabled():
            return
        _metrics.gauge(
            "mxnet_slo_burn_rate",
            help="error-budget burn rate per objective and window",
            slo=name, window="fast").set(round(burn_fast, 6))
        _metrics.gauge(
            "mxnet_slo_burn_rate", slo=name,
            window="slow").set(round(burn_slow, 6))
        _metrics.gauge(
            "mxnet_slo_error_budget_remaining",
            help="slow-window error budget left (1 = untouched)",
            slo=name).set(round(remaining, 6))
        _metrics.gauge(
            "mxnet_slo_burning",
            help="1 while the objective's burn alert is firing",
            slo=name).set(1 if burning else 0)

    def _edge(self, name, burning, burn_fast, burn_slow):
        if burning:
            _flight.record("slo.burn", slo=name,
                           burn_fast=round(burn_fast, 4),
                           burn_slow=round(burn_slow, 4))
            if _metrics.enabled():
                _metrics.counter(
                    "mxnet_slo_burn_events_total",
                    help="burn alerts fired (edge-triggered)",
                    slo=name).inc()
            if self._on_burn is not None:
                self._on_burn(name)
        else:
            _flight.record("slo.clear", slo=name,
                           burn_fast=round(burn_fast, 4),
                           burn_slow=round(burn_slow, 4))
            if self._on_clear is not None:
                self._on_clear(name)
