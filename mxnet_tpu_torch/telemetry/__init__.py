"""Telemetry for the port: metrics registry, flight recorder,
device-memory accounting, and the fleet's cross-replica pieces.

    from mxnet_tpu_torch import telemetry
    telemetry.counter("my_counter_total", my_label="x").inc()
    telemetry.snapshot()             # JSON-able dict of every family
    telemetry.flight.events(kind="fleet.attempt", last=10)
    telemetry.memdump.refresh()      # live device bytes by origin

    # fleet-wide: merge N replica snapshots, evaluate SLO burn rates
    telemetry.aggregate.merge_snapshots({"r0": snap0, "r1": snap1})
    telemetry.slo.SLOEngine().observe(merged)

    # one timeline from N per-process trace dumps
    telemetry.merge_traces(["r0.json", "r1.json"], out="merged.json")
"""
from .metrics import (  # noqa: F401
    counter, gauge, histogram,
    enabled, enable, disable,
    snapshot, prometheus_text, render_text, dump, reset,
    register_collector, record_compile,
)
from .trace import merge_traces  # noqa: F401
from . import aggregate  # noqa: F401
from . import flight  # noqa: F401
from . import memdump  # noqa: F401
from . import slo  # noqa: F401
