"""The port's compile cache and saved signatures (the counterpart of
``mxnet_tpu/compile_cache.py``).

The JAX package caches XLA executables on disk and serializes them into
MXAOT1 bundles.  The port has two kinds of compile product, and a CUDA
graph that cannot be written to a file:

1. **The disk cache.**  The nvcc libraries of ``ops/_build.py`` and the
   NVRTC cubins of ``mx.rtc`` are kept in one directory and reused by
   later processes.  ``MXNET_COMPILE_CACHE`` keeps the JAX package's
   contract: ``0`` (or ``false``, ``off``, ``no``) turns reuse across
   processes off, ``1`` forces it on, a *path* forces it on with that
   directory, and the default ``auto`` turns it on when CUDA is
   available or a directory is named.  ``MXNET_COMPILE_CACHE_DIR`` names
   the directory (default
   ``build/`` at the repo root, gitignored), ``MXNET_COMPILE_CACHE_MIN_SECS``
   the shortest NVRTC compile worth writing (default 0: an NVRTC compile
   takes well under the JAX package's 1 s default) and
   ``MXNET_COMPILE_CACHE_BUDGET_MB`` a size budget, enforced here by
   least-recent use (a hit touches the file) when the cache is configured
   and at exit, each eviction counted.  With the cache off a process
   builds its libraries into a directory of its own under ``build/``,
   removed at exit, and keeps its cubins in memory: nothing is reused
   across processes, and every kernel is still built and launched.  An
   evicted library that a live process has loaded stays mapped in it.

2. **Bundles.**  ``save_bundle``/``load_bundle`` write and read the
   port's own format (magic ``MXTTAOT1``, then JSON): torch's and CUDA's
   versions, the card's name and compute capability, and the entries.
   An entry holds call signatures and names, never a graph: a fresh
   process captures each saved signature ahead of its first call
   (``hybridize(aot=path)``, ``JitTrainStep.load_executable``).
   ``load_bundle`` raises ``MXNetError`` on a bad magic or another
   capability and warns on another torch version.  The port cannot read
   MXAOT1.

Counters: ``hits``, ``writes``, ``requests`` (``misses`` is derived),
``evictions``, ``aot_loads`` (signatures captured from bundles),
``aot_saves`` (entries written) and ``aot_unusable`` (bundles a block
could not use and captured live instead), published through
``telemetry.metrics`` as ``mxnet_compile_cache_*``.  The cache is
configured lazily, at the first build, compile or bundle, so importing
the package touches no card.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import shutil
import threading
import warnings

from .base import MXNetError, atomic_path

_AOT_MAGIC = b"MXTTAOT1\n"
_FORMAT = 1

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
# the kinds of entry the budget governs: nvcc libraries and NVRTC cubins
_SUFFIXES = (".so", ".cubin")

_lock = threading.RLock()
_stats = {"hits": 0, "writes": 0, "requests": 0, "evictions": 0,
          "aot_loads": 0, "aot_saves": 0, "aot_unusable": 0}
_state = {"configured": False, "enabled": False, "dir": None,
          "private": None, "budget_mb": 0.0, "min_secs": 0.0,
          "collector": False, "atexit": False}
_memory = {}        # cubins of this process when the cache is off


def _looks_like_path(raw):
    return (os.sep in raw or raw.startswith(("~", ".", "$"))
            or bool(os.altsep and os.altsep in raw))


def _cuda_available():
    import torch

    return torch.cuda.is_available()


def configure(env=None):
    """Resolve the ``MXNET_COMPILE_CACHE*`` contract from ``env`` (default
    the process's) and apply it; returns whether the disk cache is on.
    Never raises: a malformed number reads as its default."""
    if env is None:
        env = os.environ
    raw = env.get("MXNET_COMPILE_CACHE", "auto")
    mode = raw.strip().lower()
    with _lock:
        _state["configured"] = True
        path = env.get("MXNET_COMPILE_CACHE_DIR") or None
        if mode in ("0", "false", "off", "no"):
            enabled = False
        elif mode in ("1", "true", "on", "yes"):
            enabled = True
        elif mode != "auto" and _looks_like_path(raw):
            enabled = True
            path = path or os.path.expandvars(os.path.expanduser(raw))
        else:       # auto: an explicit directory opts a host process in
            enabled = bool(path) or _cuda_available()
        _state["enabled"] = enabled
        _state["dir"] = (path or DEFAULT_DIR) if enabled else None
        for key, name, default in (
                ("budget_mb", "MXNET_COMPILE_CACHE_BUDGET_MB", 0.0),
                ("min_secs", "MXNET_COMPILE_CACHE_MIN_SECS", 0.0)):
            try:
                _state[key] = float(env.get(name, "") or default)
            except ValueError:
                _state[key] = default
        _ensure_collector()
        if not _state["atexit"]:
            atexit.register(_at_exit)
            _state["atexit"] = True
    enforce_budget()
    return enabled


def _configured():
    if not _state["configured"]:
        configure()


def enabled():
    """Whether compile products are reused across processes."""
    _configured()
    return _state["enabled"]


def cache_dir():
    """The disk cache's directory, or None when the cache is off."""
    _configured()
    return _state["dir"] if _state["enabled"] else None


def library_dir():
    """Where nvcc libraries go: the cache's directory, or with the cache
    off this process's own directory under ``build/`` (made at the first
    build, removed at exit)."""
    _configured()
    if _state["enabled"]:
        return _state["dir"]
    with _lock:
        if _state["private"] is None:
            _state["private"] = os.path.join(
                DEFAULT_DIR, "private-%d-%s" % (
                    os.getpid(), os.urandom(4).hex()))
        return _state["private"]


def _at_exit():
    enforce_budget()
    private = _state["private"]
    if private is not None:
        shutil.rmtree(private, ignore_errors=True)


def _count(name, n=1):
    with _lock:
        _stats[name] += n


def stats():
    """The counters, with ``misses`` = requests - hits."""
    with _lock:
        out = dict(_stats)
    out["misses"] = max(0, out["requests"] - out["hits"])
    return out


def _entries(d):
    """``[(mtime, size, path)]`` of the cache's entries in ``d``."""
    out = []
    try:
        scan = list(os.scandir(d))
    except OSError:
        return out
    for ent in scan:
        if not ent.name.endswith(_SUFFIXES) or ".tmp." in ent.name:
            continue
        try:
            if ent.is_file():
                st = ent.stat()
                out.append((st.st_mtime, st.st_size, ent.path))
        except OSError:
            continue
    return out


def cache_size_bytes():
    d = cache_dir()
    return sum(size for _, size, _ in _entries(d)) if d else 0


def enforce_budget(budget_mb=None):
    """Remove the least recently used entries until the directory fits
    ``budget_mb`` (default ``MXNET_COMPILE_CACHE_BUDGET_MB``; 0 is no
    budget).  Returns how many were evicted, each counted."""
    if budget_mb is None:
        budget_mb = _state["budget_mb"]
    d = _state["dir"] if _state["enabled"] else None
    if not budget_mb or budget_mb <= 0 or not d or not os.path.isdir(d):
        return 0
    budget = float(budget_mb) * 1024 * 1024
    entries = sorted(_entries(d))
    total = sum(size for _, size, _ in entries)
    evicted = 0
    for _, size, path in entries:
        if total <= budget:
            break
        try:
            os.remove(path)     # a process that mapped it keeps its mapping
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        _count("evictions", evicted)
    return evicted


def touch(path):
    """Mark ``path`` used now (its LRU recency)."""
    try:
        os.utime(path)
    except OSError:
        pass


def library_request(path):
    """Count a request for the nvcc library at ``path``; True (and a
    hit, touched) when it is there already."""
    _count("requests")
    if os.path.exists(path):
        _count("hits")
        touch(path)
        return True
    return False


def library_written():
    """Count an nvcc library written to the directory."""
    _count("writes")


# -- NVRTC cubins ---------------------------------------------------------

def cubin_key(source, name, options, name_expressions, arch, version):
    """The cache key of one NVRTC program: a hash of its source, file
    name, options, name expressions, architecture and NVRTC's version."""
    h = hashlib.sha256()
    for part in (source, name, "\0".join(options),
                 "\0".join(name_expressions), arch, "%d.%d" % version):
        h.update(part.encode())
        h.update(b"\1")
    return h.hexdigest()[:24]


def _cubin_path(key):
    return os.path.join(cache_dir(), "nvrtc-%s.cubin" % key)


def cubin_get(key):
    """``(cubin, {expression: lowered name})`` of ``key``, or None."""
    _count("requests")
    got = _memory.get(key)
    if got is not None or not enabled():
        if got is not None:
            _count("hits")
        return got
    path = _cubin_path(key)
    try:
        with open(path, "rb") as f:
            head = f.readline()
            cubin = f.read()
        lowered = json.loads(head.decode())
    except (OSError, ValueError):
        return None
    _count("hits")
    touch(path)
    return cubin, lowered


def cubin_put(key, cubin, lowered, seconds):
    """Keep a compiled program: on disk when the cache is on and the
    compile took at least ``MXNET_COMPILE_CACHE_MIN_SECS``, else in this
    process's memory."""
    if not enabled() or seconds < _state["min_secs"]:
        _memory[key] = (cubin, dict(lowered))
        return
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    with atomic_path(_cubin_path(key)) as tmp:
        with open(tmp, "wb") as f:
            f.write(json.dumps(lowered).encode() + b"\n")
            f.write(cubin)
    _count("writes")


# -- bundles --------------------------------------------------------------

def device_doc():
    """What a bundle records of the process: torch's and CUDA's versions,
    the card's name and compute capability (None without a card)."""
    import torch

    doc = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": None, "capability": None}
    if torch.cuda.is_available():
        doc["device"] = torch.cuda.get_device_name(0)
        doc["capability"] = list(torch.cuda.get_device_capability(0))
    return doc


def save_bundle(path, entries, meta=None):
    """Write a bundle of ``entries`` (JSON-serializable) and ``meta``,
    atomically."""
    doc = dict(device_doc(), format=_FORMAT, meta=dict(meta or {}),
               entries=dict(entries))
    body = json.dumps(doc, sort_keys=True).encode()
    with atomic_path(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(_AOT_MAGIC)
            f.write(body)
    _count("aot_saves", len(doc["entries"]))


def load_bundle(path):
    """Read a bundle; its magic and the card's capability are checked
    before anything is used."""
    try:
        with open(path, "rb") as f:
            magic = f.read(len(_AOT_MAGIC))
            if magic != _AOT_MAGIC:
                raise MXNetError("%s is not an mxnet_tpu_torch bundle (bad "
                                 "magic %r; the port cannot read MXAOT1)"
                                 % (path, magic))
            doc = json.loads(f.read().decode())
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError("failed to read bundle %s (%s: %s)"
                         % (path, type(e).__name__, e))
    here = device_doc()
    if doc.get("capability") != here["capability"]:
        raise MXNetError(
            "bundle %s was saved on a card of compute capability %s (%s) "
            "but this process runs %s (%s): save it again on the target"
            % (path, doc.get("capability"), doc.get("device"),
               here["capability"], here["device"]))
    if doc.get("torch") != here["torch"]:
        warnings.warn("bundle %s was saved under torch %s (running %s)"
                      % (path, doc.get("torch"), here["torch"]))
    return doc


def count_aot_loads(n):
    _count("aot_loads", n)


def count_unusable():
    _count("aot_unusable")


def _collector():
    from .telemetry import metrics as _m

    snap = stats()
    for name, what in (
            ("hits", "Compile products reused from the disk cache"),
            ("misses", "Compile requests the cache could not serve"),
            ("writes", "Compile products written to the disk cache"),
            ("evictions", "Entries evicted by MXNET_COMPILE_CACHE_BUDGET_MB"),
            ("aot_loads", "Signatures captured ahead of a call from bundles"),
            ("aot_saves", "Entries written into bundles"),
            ("aot_unusable", "Bundles a block could not use")):
        _m.counter("mxnet_compile_cache_%s_total" % name, what).set(
            snap[name])
    if _state["enabled"]:
        _m.gauge("mxnet_compile_cache_size_bytes",
                 "Bytes of the disk cache's entries").set(cache_size_bytes())


def _ensure_collector():
    if not _state["collector"]:
        from .telemetry import metrics as _m

        _m.register_collector(_collector)
        _state["collector"] = True

