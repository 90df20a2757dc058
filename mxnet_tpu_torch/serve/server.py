"""LlamaServer: continuous-batching serving over the paged arena, on
PyTorch.

The port of ``mxnet_tpu/serve/server.py``.  Startup loads a port bundle
(weights + geometry, ``serve/model.py``) onto the device, builds the
arena with zero tensors, and spins one scheduler thread.

The runner is the only torch-touching layer: :class:`TorchRunner` calls
the step functions on the arena's tensors (they update the arena in
place), and hands numpy logits back to the scheduler, which is the JAX
package's host-side scheduler copied as it is.  Sampling is host-side
numpy, so the decode loop's device work is one step-function call per
step: on the card, one replay of that step's captured CUDA graph.

``static_generate`` is the naive baseline a serving bench compares
against: fixed batches, no mid-flight admission, every batch runs until
its slowest member finishes — same runner, same arena, so the measured
gap is pure scheduling.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import select
import socket
import threading
import time

import numpy as np
import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from ..telemetry import flight as _flight
from ..telemetry import memdump as _memdump
from ..telemetry import metrics as _metrics
from ..testing import faults as _faults
from ..testing import lockcheck as _lockcheck
from ..testing import rescheck as _rescheck
from .arena import PagedKVArena
from .scheduler import (Request, Scheduler, ServeCancelled,
                        ServeDeadlineExceeded, ServeDraining,
                        ServeInternalError, ServeQueueFull,
                        ServeSessionBusy, ServeSessionUnknown, ServeShutdown,
                        _env_float, _env_int)

_SERVER_IDS = itertools.count()


def _bundle_sha(path):
    """Short content hash of the loaded bundle — the /healthz field a
    fleet router uses to detect version drift and assert convergence
    after a rolling deploy.  Hashes file bytes when ``path`` is a real
    bundle; falls back to hashing the string for the scripted swaps the
    chaos suite performs (``from_parts`` servers have no file)."""
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read())
    except OSError:
        digest = hashlib.sha256(str(path).encode())
    return digest.hexdigest()[:16]


def _retry_after_header(retry_after_s):
    """HTTP Retry-After is delta-seconds as a non-negative integer; the
    scheduler's hint is a clamped float — round up, floor at 1."""
    try:
        return str(max(1, int(math.ceil(float(retry_after_s)))))
    except (TypeError, ValueError):
        return "1"


class TorchRunner:
    """Runs the torch step functions against one arena.

    Same surface as the JAX package's ``AOTRunner`` — ``prefill``,
    ``decode``, ``verify`` and ``chunk`` take and return numpy.  The
    step functions of ``serve/model.py`` are built once from ``weights``
    (the ``(embed, layers, norm, head)`` tensors on the arena's device).

    On a CUDA arena each step signature (``decode``, ``verify``,
    ``chunk``, one per prefill bucket) runs as one captured CUDA graph
    (``graph_cache.CapturedCall``), the counterpart of the reference's
    one AOT executable per signature: the first call runs eagerly, the
    second captures and replays, later calls replay.  Tokens, positions,
    block tables and the prefill length are copied into the graph's
    static buffers; the arena tensors are captured in place, and a moved
    arena tensor is captured again.  The graphs share one memory pool
    and one capture stream: the steps run one at a time on the serve
    thread, and each step's logits are read before the next one runs.
    ``graphs=False`` runs every call eagerly, to hold graphed results
    against eager ones.  On a CPU arena every call runs eagerly.
    """

    def __init__(self, weights, arena, graphs=True):
        from .model import (build_decode_fn, build_prefill_fn,
                            build_step_fn, build_verify_fn)

        self.arena = arena
        self.device = arena.device
        g = arena.geometry
        self._fns = {"decode": build_decode_fn(weights, g)}
        if g.spec_k > 0:
            self._fns["verify"] = build_verify_fn(weights, g)
        if g.prefill_chunk > 0:
            self._fns["chunk"] = build_step_fn(weights, g, g.prefill_chunk)
        for b in g.prefill_buckets:
            self._fns["prefill_%d" % b] = build_prefill_fn(weights, g, b)
        self._pad = {b: np.zeros(b, dtype=np.int32)
                     for b in g.prefill_buckets}
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self._graphs = _graph_cache.CallCache()   # (step, signature) -> call

    def _captured_call(self, name, args):
        fn = self._fns[name]
        return self._graphs.get(
            (name, _graph_cache.signature(args)),
            lambda *a: fn(*self.arena.buffers(), *a), self.device,
            self.arena.buffers, "serve step %s" % name)

    def graph_stats(self):
        """Captures, replays, capture seconds, host seconds outside the
        replays and the pool's bytes, over every captured step."""
        return self._graphs.stats()

    def _call(self, name, origin, label, *args):
        """Run step ``name`` over the arena state (kv tensors, plus scale
        arrays for int8) and ``args`` (host tensors), adopt the returned
        state, hand back the trailing logits as numpy.  The logits are
        tagged for memdump once per tensor: a graph returns the same
        static logits on every replay."""
        self.arena.drain_pending_readers(origin)
        with torch.no_grad():
            if self.graphs:
                cc = self._captured_call(name, args)
                captures = cc.captures
                outs = cc(*args)
                fresh = not cc.static or cc.captures != captures
            else:
                outs = self._fns[name](*self.arena.buffers(),
                                       *(a.to(self.device) for a in args))
                fresh = True
        self.arena.adopt(*outs[:-1])
        logits = outs[-1]
        if fresh:
            _memdump.tag(logits, origin="activation", label=label)
        return logits.cpu().numpy()

    def _lanes(self, name, origin, tokens, positions, block_tables):
        if name not in self._fns:
            raise MXNetError(
                "runner has no %s step — build the geometry with %s > 0"
                % (name, "spec_k" if name == "verify" else "prefill_chunk"))
        return self._call(name, origin, name + "_logits", _ints(tokens),
                          _ints(positions), _ints(block_tables))

    def prefill(self, bucket, tokens, length, block_row):
        name = "prefill_%d" % bucket
        if name not in self._fns:
            raise MXNetError("runner has no prefill step for bucket %d"
                             % bucket)
        padded = self._pad[bucket].copy()
        padded[:length] = tokens
        return self._call(name, "serve_prefill", "prefill_logits",
                          _ints(padded), _ints(length), _ints(block_row))

    def decode(self, tokens, positions, block_tables):
        return self._lanes("decode", "serve_decode", tokens, positions,
                           block_tables)

    def verify(self, tokens, positions, block_tables):
        """Speculative verify: tokens (B, spec_k+1) -> logits
        (B, spec_k+1, V)."""
        return self._lanes("verify", "serve_verify", tokens, positions,
                           block_tables)

    def chunk(self, tokens, positions, block_tables):
        """Chunked prefill: tokens (B, prefill_chunk) -> logits
        (B, prefill_chunk, V)."""
        return self._lanes("chunk", "serve_chunk", tokens, positions,
                           block_tables)


def _ints(a):
    """An int32 host tensor of ``a`` (0-d for a scalar)."""
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _load_parts(bundle_path, expect_geometry=None, kv_dtype=None,
                device=None):
    """Bundle → (geometry, runner, arena) on ``device``."""
    from .model import check_geometry, convert_weights, load_serving_bundle

    geometry, raw = load_serving_bundle(bundle_path, expect=expect_geometry)
    if kv_dtype is not None:
        check_geometry(geometry, {"kv_dtype": str(kv_dtype)},
                       origin=bundle_path)
    arena = PagedKVArena(geometry, device=device)
    weights = convert_weights(raw, geometry.dtype, arena.device)
    return geometry, TorchRunner(weights, arena), arena


class LlamaServer:
    """Continuous-batching inference server over a port serving bundle.

    ``LlamaServer(path).start()`` then ``submit(prompt) -> Request`` /
    ``generate(prompt) -> tokens``.  Geometry validation happens at
    load (``expect_geometry`` pins fields); admission backpressure
    raises ``ServeQueueFull``.

    ``spec_k`` picks the runtime speculation width (default: the
    bundle geometry's; 0 turns it off).  ``kv_dtype`` is an
    assertion, not a conversion — pass it to refuse a bundle whose
    arena dtype isn't what the deployment expects.

    Robustness (docs/serving.md "Robustness & deploys"): the
    loop is crash-contained (a step exception fails only the affected
    requests with :class:`ServeInternalError`, dumps the flight
    recorder, flips ``/healthz`` ``ok`` and restarts the loop over a
    reset arena), ``drain()``/SIGTERM stops admission and gives
    in-flight work ``MXNET_SERVE_DRAIN_TIMEOUT`` to finish, and
    ``reload(bundle)`` hot-swaps the weights + arena at a step
    boundary without dropping a request.  ``device`` defaults to
    ``cuda:0``; pass ``device="cpu"`` for a host run.
    """

    def __init__(self, bundle_path, expect_geometry=None, queue_depth=None,
                 sampler=None, spec_k=None, kv_dtype=None, device=None):
        _, runner, arena = _load_parts(bundle_path, expect_geometry,
                                       kv_dtype, device)
        self._init_core(runner, arena, queue_depth=queue_depth,
                        sampler=sampler, spec_k=spec_k)
        self.bundle_path = bundle_path
        self.bundle_sha = _bundle_sha(bundle_path)

    def _init_core(self, runner, arena, queue_depth=None, sampler=None,
                   spec_k=None, clock=time.monotonic):
        self.geometry = arena.geometry
        self.arena = arena
        self.runner = runner
        self.scheduler = Scheduler(runner, arena, queue_depth=queue_depth,
                                   sampler=sampler, spec_k=spec_k,
                                   clock=clock)
        self.bundle_path = None
        self.bundle_sha = None
        self.server_id = "srv-%x-%x" % (os.getpid(), next(_SERVER_IDS))
        self._start_t = time.monotonic()
        self._stop = threading.Event()
        self._thread = None
        self._res_thread = None       # rescheck token for the loop thread
        self._http = None
        self._healthy = True          # flips (sticky) on loop death
        self._last_loop_error = None
        self._loop_restarts = 0
        self._loop_steps = 0
        self._draining = False
        self._swap_lock = _lockcheck.named_lock("serve.swap")
        self._pending_swap = None     # (geometry, runner, arena, path, evt)
        self._max_restarts = _env_int("MXNET_SERVE_LOOP_MAX_RESTARTS", 16)

    @classmethod
    def from_parts(cls, runner, arena, queue_depth=None, sampler=None,
                   spec_k=None, clock=time.monotonic):
        """Assemble a server around an existing runner + arena, no
        bundle load — the seam the serve-chaos suite drives with
        scripted runners and an injected clock (the loop machinery —
        containment, drain, hot-swap — is exactly the production
        path)."""
        self = cls.__new__(cls)
        self._init_core(runner, arena, queue_depth=queue_depth,
                        sampler=sampler, spec_k=spec_k, clock=clock)
        return self

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        # a previous stop() closed the submit window; reopen it (a
        # loop-gave-up refusal is NOT a ServeShutdown and stays sticky)
        if isinstance(self.scheduler._refuse_error, ServeShutdown):
            self.scheduler.refuse(None)
        self._thread = threading.Thread(target=self._loop,
                                        name="mxnet-serve", daemon=True)
        self._thread.start()
        self._res_thread = _rescheck.acquire("thread", "mxnet-serve",
                                             scope="serve:%x" % id(self))
        return self

    def _loop(self):
        while not self._stop.is_set():
            if not self._loop_tick():
                self.scheduler.wait_for_work(0.005)

    def _loop_tick(self):
        """One crash-contained scheduler round (False = idle).  Tests
        drive this synchronously; the background thread just loops it."""
        try:
            _faults.maybe_inject("serve_step", step=self._loop_steps)
            self._loop_steps += 1
            self._maybe_swap()
            return self.scheduler.step()
        except Exception as e:  # noqa: BLE001 — containment IS the point
            self._contain_loop_failure(e)
            return True

    def _contain_loop_failure(self, exc):
        """An unexpected step exception must not kill the serve thread
        silently (the pre-PR failure mode: every pending future hung
        until client timeout).  Fail the affected requests typed, dump
        the flight recorder, mark /healthz not-ok, reset the arena and
        keep serving — up to MXNET_SERVE_LOOP_MAX_RESTARTS, after which
        submits are refused fast instead of queueing into a dead loop."""
        self._healthy = False
        self._last_loop_error = "%s: %s" % (type(exc).__name__, exc)
        _flight.record("serve.loop_died", error=type(exc).__name__,
                       detail=str(exc)[:200])
        _flight.crash_dump("serve_loop:%s" % type(exc).__name__)
        failed = self.scheduler.fail_all(ServeInternalError(
            "serve loop died (%s: %s) — request failed, loop restarting"
            % (type(exc).__name__, exc)), status="failed")
        self._loop_restarts += 1
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_serve_loop_restarts_total",
                help="serve-loop restarts after a contained crash").inc()
        try:
            self.arena.reset()
        except Exception as e2:
            # a poisoned arena that cannot even reset means no future
            # request can be served correctly: refuse, stop, stay not-ok
            err = ServeInternalError(
                "serve loop died and the arena failed to reset (%s) — "
                "server is down" % e2)
            self.scheduler.refuse(err)
            self.scheduler.fail_all(err, status="failed")
            self._stop.set()
            _flight.record("serve.loop_gave_up", restarts=self._loop_restarts)
            return
        _flight.record("serve.loop_restart", n=self._loop_restarts,
                       failed=failed)
        if self._loop_restarts >= self._max_restarts:
            err = ServeInternalError(
                "serve loop died %d times (MXNET_SERVE_LOOP_MAX_RESTARTS"
                "=%d) — giving up; last error: %s"
                % (self._loop_restarts, self._max_restarts,
                   self._last_loop_error))
            self.scheduler.refuse(err)
            self.scheduler.fail_all(err, status="failed")
            self._stop.set()
            _flight.record("serve.loop_gave_up", restarts=self._loop_restarts)

    def stop(self):
        self._stop.set()
        # close the submit window BEFORE the straggler sweep: a submit
        # racing the has_work() check below would otherwise queue a
        # future nobody ever resolves (the loop is gone and fail_all
        # already ran) — with the refusal set it fails typed instead.
        # start() reopens the window.
        self.scheduler.refuse(
            ServeShutdown("server is stopped — not accepting requests"))
        self.scheduler.kick()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        _rescheck.release(self._res_thread)
        self._res_thread = None
        with self._swap_lock:
            self._pending_swap = None  # a waiting reload() times out
        # never abandon futures: anything still
        # queued or in flight fails typed instead of hanging clients
        if self.scheduler.has_work():
            self.scheduler.fail_all(
                ServeShutdown("server stopped with the request still "
                              "queued or in flight"), status="drained")
        if self._http is not None:
            self._http.shutdown()
            self._http = None
        # shared pages (prefix cache, pinned sessions) are not "work" —
        # flush them explicitly or the quiescence asserts below see them
        self.scheduler.release_shared()
        if _rescheck.enabled():
            # the every-handle-kind generalization of
            # arena.assert_quiescent(): no live futures, no live pages
            _rescheck.assert_quiescent(scope=self.scheduler.res_scope)
            _rescheck.assert_quiescent(scope=self.arena.res_scope)

    def drain(self, timeout=None):
        """Graceful shutdown, phase 1: stop admission (new submits get
        503 + Retry-After), let queued + in-flight work finish within
        ``timeout`` (default ``MXNET_SERVE_DRAIN_TIMEOUT``), then fail
        stragglers with :class:`ServeShutdown`.  Returns the straggler
        count (0 = clean drain).  Call ``stop()`` after."""
        if timeout is None:
            timeout = _env_float("MXNET_SERVE_DRAIN_TIMEOUT", 30.0)
        timeout = float(timeout)
        self._draining = True
        self.scheduler.drain()
        _flight.record("serve.drain", timeout_s=timeout,
                       queued=self.scheduler.queue_len(),
                       active=self.scheduler.active_slots())
        deadline = time.monotonic() + timeout
        while self.scheduler.has_work() and time.monotonic() < deadline:
            if self._thread is None:
                if not self.scheduler.step():
                    break  # no loop and no progress possible
            else:
                time.sleep(0.005)
        self.scheduler.hold_admission(True)
        stragglers = 0
        if self.scheduler.has_work():
            stragglers = self.scheduler.fail_all(ServeShutdown(
                "drain timed out after %.1fs "
                "(MXNET_SERVE_DRAIN_TIMEOUT) with the request still "
                "queued or in flight" % timeout), status="drained")
        _flight.record("serve.drained", stragglers=stragglers)
        # in-flight turns are finished (or failed) by now: unpin every
        # session and drop the prefix cache so the arena reaches true
        # quiescence — a drained server holds zero pages
        self.scheduler.release_shared()
        if _rescheck.enabled():
            _rescheck.assert_quiescent(scope=self.scheduler.res_scope)
            _rescheck.assert_quiescent(scope=self.arena.res_scope)
        return stragglers

    # -- bundle hot-swap --------------------------------------------------
    def reload(self, bundle_path, timeout=60):
        """Hot-swap to a new serving bundle with zero dropped requests:
        load its weights onto the device on the CALLING thread (the loop
        keeps serving), pin the geometry fields live traffic depends on
        (``KVGeometry.hot_swap_pins``), then hand runner + fresh arena to
        the loop, which swaps them at the first step boundary with no
        active lanes — in-flight requests finish on the old weights,
        queued requests wait (admission held, never dropped) and prefill
        into the new arena."""
        g2, runner2, arena2 = _load_parts(
            bundle_path, self.geometry.hot_swap_pins(),
            device=self.arena.device)
        done = threading.Event()
        with self._swap_lock:
            if self._pending_swap is not None:
                raise MXNetError("a reload is already in flight")
            self._pending_swap = (g2, runner2, arena2, bundle_path, done)
        if self._thread is None:
            # no background loop: drain lanes and swap on this thread
            while self.scheduler.active_slots():
                self.scheduler.step()
            self._maybe_swap()
        else:
            self.scheduler.kick()
            if not done.wait(timeout):
                with self._swap_lock:
                    self._pending_swap = None
                self.scheduler.hold_admission(False)
                raise MXNetError(
                    "reload of %r timed out after %ss (loop stalled or "
                    "lanes never drained)" % (bundle_path, timeout))
        return self

    def _maybe_swap(self):
        """Loop-side half of ``reload()``: runs at every step boundary,
        holds admission while old lanes drain, then swaps atomically."""
        with self._swap_lock:
            if self._pending_swap is None:
                return
        self.scheduler.hold_admission(True)
        if self.scheduler.active_slots():
            return  # old lanes still decoding on the old runner
        with self._swap_lock:
            pend = self._pending_swap
            if pend is None:  # reload() timed out and withdrew
                self.scheduler.hold_admission(False)
                return
            self._pending_swap = None
        g2, runner2, arena2, path, done = pend
        self.scheduler.swap(runner2, arena2)
        self.geometry, self.runner, self.arena = g2, runner2, arena2
        self.bundle_path = path
        self.bundle_sha = _bundle_sha(path)
        self.scheduler.hold_admission(False)
        if _metrics.enabled():
            _metrics.counter(
                "mxnet_serve_reloads_total",
                help="bundle hot-swaps completed").inc()
        _flight.record("serve.reload", bundle=str(path))
        done.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- request surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               deadline_s=None, session=None, trace_id=None):
        """Enqueue; returns the Request future (``.result(timeout)``).
        ``session`` is a session id from :meth:`open_session` — the turn
        prefills only its delta on top of the pinned history.
        ``trace_id`` overrides the self-minted id (the FleetRouter's
        fleet trace id, or an ``X-MXNet-Trace`` header value)."""
        if self._thread is None:
            raise MXNetError("server not started — call start() first")
        return self.scheduler.submit(
            Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    deadline_s=deadline_s, session_id=session,
                    trace_id=trace_id))

    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 timeout=300, deadline_s=None, session=None):
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id, deadline_s=deadline_s,
                           session=session).result(timeout)

    def open_session(self):
        """Create a pinned multi-turn chat session; returns its id."""
        return self.scheduler.open_session()

    def close_session(self, session_id):
        """Unpin a session's pages; True if it existed."""
        return self.scheduler.close_session(session_id)

    def cancel(self, trace_id):
        """Cancel a queued or in-flight request by trace id (the HTTP
        front's ``DELETE /v1/generate/<id>``); True if it was found."""
        return self.scheduler.cancel(trace_id)

    def stats(self):
        return self.scheduler.stats()

    def healthy(self):
        """Readiness: False once the loop has died (sticky — the flight
        dump names why) or while draining — the signal a load balancer
        routes away on."""
        return self._healthy and not self._draining

    def healthz(self):
        """The GET /healthz body: scheduler stats plus the operational
        signals an external prober actually pages on — arena pressure,
        queue depth, live device memory, flight-recorder state."""
        st = self.scheduler.stats()
        try:
            by_origin, total = _memdump.refresh()
        except Exception:           # health must not 500 on accounting
            by_origin, total = {}, 0
        st.update({
            "ok": self.healthy(),
            "draining": self._draining,
            "bundle_sha": self.bundle_sha,
            "server_id": self.server_id,
            "uptime_s": round(time.monotonic() - self._start_t, 3),
            "loop_restarts": self._loop_restarts,
            "last_loop_error": self._last_loop_error,
            "queue_depth": st["queue_len"],
            "live_device_bytes": total,
            "device_bytes_by_origin": by_origin,
            "peak_device_bytes": _memdump.peak_bytes(),
            "flight": _flight.status(),
            "membership": self._membership_health(),
        })
        return st

    @staticmethod
    def _membership_health():
        """Elastic-membership view from the metrics registry (zeros when
        this process hosts no kvstore shard): the prober that pages on
        queue depth also sees roster shrink without scraping /metrics."""
        from ..telemetry import metrics as _metrics

        snap = _metrics.snapshot()

        def val(fam, default=0):
            series = snap.get(fam, {}).get("series", [])
            return series[0].get("value", default) if series else default

        return {
            "epoch": int(val("mxnet_membership_epoch")),
            "ranks_active": int(val("mxnet_ranks_active")),
            "evictions_total": int(sum(
                s.get("value", 0) for s in
                snap.get("mxnet_rank_evictions_total",
                         {}).get("series", []))),
        }

    # -- naive baseline (bench comparison) --------------------------------
    def static_generate(self, requests):
        """Static batching: groups of ``max_batch``, no admission between
        steps, each group decodes until its SLOWEST member finishes.
        Returns the token lists in request order.  Runs on the caller's
        thread — stop() the background loop first or don't start() it.
        """
        g = self.geometry
        sched = self.scheduler
        out = []
        for base in range(0, len(requests), g.max_batch):
            group = requests[base: base + g.max_batch]
            slots = []
            for req in group:
                pages = self.arena.alloc(
                    self.arena.pages_needed(
                        len(req.prompt) + req.max_new_tokens), req.rid)
                if pages is None:
                    # earlier members of this group already hold pages —
                    # give them back or the arena leaks them for good
                    for prev, prev_pages, _ in slots:
                        self.arena.free(prev_pages, owner=prev.rid)
                    raise MXNetError("arena too small for a static batch")
                row = self.arena.block_row(pages)
                logits = self.runner.prefill(
                    sched.pick_bucket(len(req.prompt)),
                    np.asarray(req.prompt, dtype=np.int32),
                    len(req.prompt), row)
                req.tokens.append(sched.sampler(logits, req))
                slots.append((req, pages, row))
            # the whole group decodes in lockstep until every member is
            # done — finished lanes keep burning a slot (that waste IS
            # the baseline being measured)
            def _busy(req):
                if len(req.tokens) >= req.max_new_tokens:
                    return False
                return not (req.eos_id is not None
                            and req.tokens[-1] == req.eos_id)
            while any(_busy(req) for req, _, _ in slots):
                tokens = np.zeros(g.max_batch, dtype=np.int32)
                positions = np.zeros(g.max_batch, dtype=np.int32)
                tables = np.zeros((g.max_batch, g.max_pages_per_seq),
                                  dtype=np.int32)
                for i, (req, _, row) in enumerate(slots):
                    tokens[i] = req.tokens[-1]
                    positions[i] = len(req.prompt) + len(req.tokens) - 1
                    tables[i] = row
                logits = self.runner.decode(tokens, positions, tables)
                for i, (req, _, _) in enumerate(slots):
                    if _busy(req):
                        req.tokens.append(sched.sampler(logits[i], req))
            for req, pages, _ in slots:
                self.arena.free(pages, owner=req.rid)
                out.append(list(req.tokens))
        return out

    # -- HTTP front -------------------------------------------------------
    def serve_http(self, port=0, host="127.0.0.1"):
        """Minimal stdlib HTTP front (POST /v1/generate, POST /v1/chat,
        GET /metrics, GET /metrics.json, GET /healthz,
        GET /v1/trace/<id>, DELETE /v1/generate/<id>,
        DELETE /v1/chat/<id>).  Returns the bound (host, port).
        A POST may carry an ``X-MXNet-Trace`` header (the FleetRouter's
        fleet trace id): it becomes the request's ``trace_id``, so
        router and replica flight events correlate on one id.

        Status mapping: draining / queue-full → 503 with a
        ``Retry-After`` header derived from queue depth × decode-pace
        EMA; deadline exceeded → 504; cancelled → 409; shutdown /
        internal → 503; anything else → 500.  /healthz returns 503 once
        the loop has died or while draining, so probers flip without
        parsing the body."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        def _error_code(err):
            if isinstance(err, ServeDeadlineExceeded):
                return 504
            if isinstance(err, ServeSessionUnknown):
                return 404
            if isinstance(err, (ServeCancelled, ServeSessionBusy)):
                return 409
            if isinstance(err, (ServeShutdown, ServeInternalError,
                                ServeDraining, ServeQueueFull)):
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

            def _await_or_cancel(self, req, timeout):
                """Wait for the result while watching the client socket:
                a connection closed mid-decode cancels the request (its
                pages free at the next step boundary) instead of burning
                decode steps for a reader that is gone.  True = settled
                or timed out, False = client disconnected."""
                t_end = time.monotonic() + timeout
                while not req._done.wait(0.05):
                    if time.monotonic() >= t_end:
                        return True
                    try:
                        r, _, _ = select.select([self.connection], [], [],
                                                0)
                        gone = bool(r) and self.connection.recv(
                            1, socket.MSG_PEEK) == b""
                    except (OSError, ValueError):
                        gone = True
                    if gone:
                        server.cancel(req.trace_id)
                        return False
                return True

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, _metrics.prometheus_text(),
                               ctype="text/plain; version=0.0.4")
                elif self.path == "/metrics.json":
                    # full registry snapshot — the fleet aggregator's
                    # scrape format (labels survive as structure, not
                    # re-parsed exposition text)
                    self._send(200, _metrics.snapshot())
                elif self.path == "/healthz":
                    body = server.healthz()
                    if body["ok"]:
                        self._send(200, body)
                    else:
                        # not-ok/draining 503s back off external load
                        # balancers exactly like queue-full ones do
                        self._send(503, body, headers={
                            "Retry-After": _retry_after_header(
                                server.scheduler.retry_after_s())})
                elif self.path.startswith("/v1/trace/"):
                    tid = self.path[len("/v1/trace/"):]
                    tr = server.scheduler.trace(tid)
                    if tr is None:
                        self._send(404, {"error": "unknown trace id %r "
                                                  "(evicted or never seen)"
                                                  % tid})
                    else:
                        self._send(200, tr)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/v1/generate", "/v1/chat"):
                    self._send(404, {"error": "not found"})
                    return
                chat = self.path == "/v1/chat"
                sid = None
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    if chat:
                        # no "session" field = first turn: open one and
                        # return its id so the client can keep it warm
                        sid = doc.get("session") or server.open_session()
                    req = server.submit(
                        doc["prompt"],
                        max_new_tokens=doc.get("max_new_tokens"),
                        eos_id=doc.get("eos_id"),
                        deadline_s=doc.get("deadline_s"),
                        session=sid,
                        trace_id=self.headers.get("X-MXNet-Trace"))
                except ServeSessionUnknown as e:
                    self._send(404, {"error": str(e)})
                    return
                except ServeSessionBusy as e:
                    self._send(409, {"error": str(e)})
                    return
                except (ServeDraining, ServeQueueFull) as e:
                    self._send(503, {"error": str(e)},
                               headers={"Retry-After": _retry_after_header(
                                   getattr(e, "retry_after_s", 1))})
                    return
                except ServeInternalError as e:  # loop gave up: refusing
                    self._send(503, {"error": str(e)})
                    return
                except (MXNetError, KeyError, ValueError) as e:
                    self._send(400, {"error": str(e)})
                    return
                if req.done() and req.error is not None:
                    # rejected at submit (prompt over the bucket ladder,
                    # budget over max context): client error, not a 500
                    self._send(400, {"error": str(req.error)})
                    return
                if not self._await_or_cancel(req,
                                             doc.get("timeout", 300)):
                    return  # client went away: request cancelled
                try:
                    tokens = req.result(timeout=0.001)
                except MXNetError as e:
                    self._send(_error_code(req.error or e),
                               {"error": str(e),
                                "trace_id": req.trace_id,
                                "session": sid} if chat else
                               {"error": str(e),
                                "trace_id": req.trace_id})
                    return
                body = {"tokens": tokens,
                        "ttft_s": req.ttft,
                        "trace_id": req.trace_id,
                        "breakdown": req.breakdown()}
                if chat:
                    body["session"] = sid
                self._send(200, body)

            def do_DELETE(self):
                if self.path.startswith("/v1/chat/"):
                    sid = self.path[len("/v1/chat/"):]
                    try:
                        closed = server.close_session(sid)
                    except ServeSessionBusy as e:
                        self._send(409, {"error": str(e)})
                        return
                    if closed:
                        self._send(200, {"closed": sid})
                    else:
                        self._send(404, {"error": "no session %r "
                                                  "(expired or never "
                                                  "opened)" % sid})
                    return
                if not self.path.startswith("/v1/generate/"):
                    self._send(404, {"error": "not found"})
                    return
                tid = self.path[len("/v1/generate/"):]
                if server.cancel(tid):
                    self._send(200, {"cancelled": tid})
                else:
                    self._send(404, {"error": "no queued or in-flight "
                                              "request with trace id %r"
                                              % tid})

        self._http = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._http.serve_forever,
                         name="mxnet-serve-http", daemon=True).start()
        return self._http.server_address


def poisson_workload(n_requests, rate_rps, prompt_range, max_new_range,
                     vocab_size, seed=0, eos_id=None):
    """Seeded mixed-length Poisson workload: ``[(arrival_s, Request)]``.

    Prompt lengths draw uniform over ``prompt_range``; generation budgets
    draw a geometric-ish heavy tail clipped to ``max_new_range`` — the
    length spread is what separates continuous batching from the static
    baseline (a static batch runs at the pace of its slowest member).
    """
    rng = np.random.default_rng(seed)
    lo_p, hi_p = prompt_range
    lo_n, hi_n = max_new_range
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_requests))
    out = []
    for i in range(n_requests):
        plen = int(rng.integers(lo_p, hi_p + 1))
        budget = int(np.clip(lo_n + rng.geometric(
            2.0 / (lo_n + hi_n)), lo_n, hi_n))
        prompt = rng.integers(0, vocab_size, size=plen).tolist()
        out.append((float(arrivals[i]),
                    Request(prompt, max_new_tokens=budget, eos_id=eos_id)))
    return out


def drive_workload(server, workload, timeout=600, clock=time.monotonic,
                   sleep=time.sleep):
    """Replay a :func:`poisson_workload` against a started server.

    Returns ``(requests, wall_seconds)`` — wall time from first submit to
    last completion.  Used by the serving bench and the serve-smoke CI
    job (which passes a null ``sleep`` to hammer the queue).
    """
    t0 = clock()
    reqs = []
    for arrival, req in workload:
        lag = arrival - (clock() - t0)
        if lag > 0:
            sleep(lag)
        try:
            server.scheduler.submit(req)
        except MXNetError as e:  # queue-full backpressure: shed, record
            if req.error is None:
                req.error = e
            req._done.set()
        reqs.append(req)
    for req in reqs:
        try:
            req.result(timeout=timeout)
        except MXNetError:
            pass  # rejected/failed requests surface via req.error
    return reqs, clock() - t0
