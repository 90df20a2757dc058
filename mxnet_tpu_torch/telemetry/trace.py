"""Merge per-process chrome traces into one correlated timeline.

Each process's profiler records event timestamps relative to its own
``perf_counter`` epoch, so two dumps cannot be overlaid as-is.  The
profiler therefore embeds a wall-clock anchor in every dump
(``otherData.wall_t0_us`` = ``time.time()`` at profiler import, i.e.
the wall time of local ``ts == 0``).  :func:`merge_traces` aligns all
inputs to the earliest anchor: an event at local ``ts`` in trace *i*
lands at ``ts + (wall0_i - min_j wall0_j)`` on the merged timeline.

pid layout: events recorded at ``pid >= 1`` (a server's handler
spans, at ``pid = rank + 1``) keep that pid verbatim; each input
trace's local events (``pid == 0``) move to a fresh pid above all of
them so N processes don't collapse onto one track.  The result is one
chrome://tracing / Perfetto file; ``tools/torch_mxflight.py`` and
``tools/torch_mxtrace.py`` use it to lay the port's flight-recorder
dumps (fleet replicas, the router) side by side.
"""
from __future__ import annotations

import json


def _load(t):
    """Accept a path, a full trace dict, or a bare event list."""
    if isinstance(t, str):
        with open(t) as f:
            t = json.load(f)
    if isinstance(t, list):
        t = {"traceEvents": t}
    return t


def merge_traces(traces, out=None, labels=None):
    """Merge chrome traces (paths / dicts / event lists) into one dict.

    ``labels`` optionally names each input (defaults to ``worker<i>``);
    server pids get named ``server<rank>``.  Writes JSON to ``out`` when
    given.  Returns the merged trace dict.
    """
    loaded = [_load(t) for t in traces]
    anchors = [t.get("otherData", {}).get("wall_t0_us") for t in loaded]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else 0.0

    merged = []
    server_pids = set()
    for t in loaded:
        for e in t.get("traceEvents", []):
            pid = e.get("pid", 0)
            if pid != 0:
                server_pids.add(pid)
    next_pid = max(server_pids) + 1 if server_pids else 1

    pid_names = {}
    for i, t in enumerate(loaded):
        shift = (anchors[i] - base) if anchors[i] is not None else 0.0
        local_pid = next_pid
        next_pid += 1
        pid_names[local_pid] = (labels[i] if labels and i < len(labels)
                                else "worker%d" % i)
        for e in t.get("traceEvents", []):
            e = dict(e)
            if "ts" in e:
                e["ts"] = e["ts"] + shift
            pid = e.get("pid", 0)
            if pid == 0:
                e["pid"] = local_pid
            merged.append(e)

    for pid in sorted(server_pids):
        # servers record handler spans at pid = requesting worker's
        # rank + 1
        pid_names.setdefault(pid, "server:rank%d" % (pid - 1))
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}}
            for pid, name in sorted(pid_names.items())]

    result = {"traceEvents": meta + merged, "displayTimeUnit": "ms"}
    if out:
        with open(out, "w") as f:
            json.dump(result, f)
    return result
