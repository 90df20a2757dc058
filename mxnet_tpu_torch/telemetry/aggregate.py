"""Fleet-wide metric aggregation (docs/observability.md "Fleet
observability").

One serving fleet is N metric registries: each HTTP replica exposes its
own process-global registry (``GET /metrics.json``), in-process replicas
share ONE registry but carry per-server aggregates in their scheduler
stats.  This module merges those per-replica snapshots into one
fleet-level snapshot with Prometheus-sound semantics:

* **counters sum** across replicas per label-set (a fleet total is the
  only number an alert can threshold);
* **gauges keep per-replica series** — a ``replica`` label is added, so
  the fleet view shows three queue depths, not their meaningless sum;
* **histograms merge bucket-wise**: cumulative bucket counts, ``sum``
  and ``count`` add (a sum of cumulative counts is the cumulative count
  of the union), so ``histogram_quantile`` over the merged series is
  the fleet-wide quantile.

Every function here works on :func:`telemetry.snapshot`-shaped dicts —
``{family: {"type", "help", "series": [...]}}`` — never on live metric
objects, so aggregation is pure and scrape-time cheap.

:func:`snapshot_from_stats` synthesizes a snapshot-shaped doc from one
replica's ``/healthz`` stats: the in-process fleet (bench, chaos matrix,
3-replicas-one-process CI jobs) shares a single registry, so scraping it
per replica would multiply every count by N — the per-server scheduler
aggregates are the only honestly per-replica numbers in that topology.
"""
from __future__ import annotations

__all__ = ["merge_snapshots", "snapshot_from_stats", "overlay"]


def _series_key(labels):
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def merge_snapshots(snaps):
    """Merge ``{replica_name: snapshot}`` into one fleet snapshot.

    Counters sum per label-set; gauges gain a ``replica`` label and keep
    one series per replica; histogram series merge bucket-wise per
    label-set.  Replica order is normalized (sorted) so the merge of
    the same inputs is byte-identical regardless of scrape order.
    """
    merged = {}
    acc = {}     # (family, series_key) -> accumulating entry
    for replica in sorted(snaps):
        snap = snaps[replica] or {}
        for name, fam in snap.items():
            out = merged.setdefault(
                name, {"type": fam.get("type", "counter"),
                       "help": fam.get("help", ""), "series": []})
            for s in fam.get("series", []):
                labels = dict(s.get("labels", {}))
                if out["type"] == "gauge":
                    labels["replica"] = replica
                    out["series"].append(
                        {"labels": labels, "value": s.get("value", 0)})
                    continue
                key = (name, _series_key(labels))
                entry = acc.get(key)
                if entry is None:
                    entry = {"labels": labels}
                    if out["type"] == "histogram":
                        entry.update(buckets={}, sum=0.0, count=0)
                    else:
                        entry["value"] = 0
                    acc[key] = entry
                    out["series"].append(entry)
                if out["type"] == "histogram":
                    for bound, c in s.get("buckets", {}).items():
                        entry["buckets"][bound] = \
                            entry["buckets"].get(bound, 0) + c
                    entry["sum"] += s.get("sum", 0.0)
                    entry["count"] += s.get("count", 0)
                else:
                    entry["value"] += s.get("value", 0)
    # histogram buckets render in ascending-bound order with +Inf last,
    # whatever order the inputs carried them in
    for name, fam in merged.items():
        if fam["type"] != "histogram":
            continue
        for entry in fam["series"]:
            items = sorted(entry["buckets"].items(),
                           key=lambda bc: (bc[0] == "+Inf",
                                           float(bc[0])
                                           if bc[0] != "+Inf" else 0.0))
            entry["buckets"] = dict(items)
    return merged


def overlay(merged, local):
    """Fill ``merged`` with families from ``local`` (the router's own
    registry snapshot) that the per-replica merge didn't produce.

    The replica-merged families win: in an in-process fleet the local
    registry holds the same underlying counts the per-replica synthesis
    already attributed, so adding them again would double-count.  The
    local snapshot contributes only what no replica scrape carries —
    the ``mxnet_fleet_*`` routing families, ``mxnet_slo_*`` gauges, and
    (in-process) the shared latency histograms.  Returns ``merged``.
    """
    for name, fam in (local or {}).items():
        if name not in merged:
            merged[name] = fam
    return merged


# per-server scheduler aggregates -> synthesized snapshot families.
# (family, kind, help, stats key); counters sum at merge, gauges get the
# replica label.  Gauges reuse the canonical registry names on purpose
# (a replica-labeled queue depth strictly improves on the registry's
# last-writer-wins single gauge, and overlay() lets the merged family
# win); counters get a distinct ``_replica_`` namespace so they can
# never mask a richer registry family (``mxnet_serve_requests_total``
# carries per-status labels the scheduler stats don't).  Latency
# percentiles stay out — percentiles are not mergeable (the shared
# in-process histograms cover them via overlay()).
_STATS_FAMILIES = (
    ("mxnet_serve_queue_depth", "gauge",
     "requests waiting for admission", "queue_len"),
    ("mxnet_serve_batch_occupancy", "gauge",
     "active decode slots (of max_batch)", "active_slots"),
    ("mxnet_serve_arena_utilization", "gauge",
     "fraction of arena pages in use", "arena_utilization"),
    ("mxnet_serve_sessions_active", "gauge",
     "pinned chat sessions holding arena pages between turns",
     "sessions"),
    ("mxnet_serve_replica_admitted_total", "counter",
     "requests admitted, per replica scrape", "admitted"),
    ("mxnet_serve_replica_completed_total", "counter",
     "requests completed, per replica scrape", "completed"),
    ("mxnet_serve_replica_tokens_total", "counter",
     "tokens generated, per replica scrape", "tokens_generated"),
    ("mxnet_serve_replica_decode_steps_total", "counter",
     "decode steps executed, per replica scrape", "decode_steps"),
)


def snapshot_from_stats(stats):
    """Synthesize a snapshot-shaped dict from one replica's ``healthz``/
    ``stats`` doc — the per-replica scrape for in-process fleets, where
    the process-global registry can't attribute anything to one
    replica.  Unknown/missing keys are skipped, never defaulted: a
    missing aggregate must not masquerade as a zero."""
    out = {}
    for name, kind, help_, key in _STATS_FAMILIES:
        if key not in (stats or {}):
            continue
        out[name] = {"type": kind, "help": help_,
                     "series": [{"labels": {}, "value": stats[key]}]}
    return out
