"""Build and load the port's CUDA C++ kernels.

Each source in ``mxnet_tpu_torch/csrc`` compiles with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which the
op module binds with ``ctypes``.  Libraries go to the compile cache's
directory (``compile_cache.library_dir()``: ``build/`` at the repo root
by default, gitignored), named by a hash of the source and the flags, so
an edit rebuilds and an unchanged source is built once; the cache counts
each request, hit and write.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .. import compile_cache as _ccache
from ..base import MXNetError

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = _ccache.DEFAULT_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs = {}
_libs_lock = threading.Lock()


def source_path(name):
    """``csrc/<name>`` inside the package."""
    return os.path.join(CSRC_DIR, name)


def cuda_home():
    """``$CUDA_HOME``, else ``$CUDA_PATH``, else ``/usr/local/cuda``: where
    ``nvcc``, and NVRTC for ``mx.rtc``, are looked for first."""
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"


def _nvcc():
    home = cuda_home()
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (looked in %s/bin and on PATH): "
                         "the port's kernels are built from "
                         "mxnet_tpu_torch/csrc at first use" % home)
    return found


def _flags(defines):
    return list(NVCC_FLAGS) + ["-D" + d for d in defines]


def library_path(source, defines=()):
    """Where the library built from ``source`` (with the macros
    ``defines``, ``"NAME=value"`` each) lives: the compile cache's
    library directory, named by a hash of the source, the shared headers of
    ``csrc`` (``*.cuh``) and the flags."""
    digest = hashlib.sha256()
    for path in [source] + sorted(
            os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
            if n.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_flags(defines)).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_ccache.library_dir(),
                        "%s-%s.so" % (stem, digest.hexdigest()[:12]))


def _start(source, verbose, defines=()):
    out = library_path(source, defines)
    if _ccache.library_request(out):
        return out, None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    cmd = [_nvcc(), *_flags(defines)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, (proc, tmp)


def _finish(source, out, pending, verbose):
    if pending is None:
        return out
    proc, tmp = pending
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise MXNetError("nvcc failed building %s:\n%s%s"
                         % (source, stdout, stderr))
    if verbose and (stdout or stderr):
        print(stdout + stderr, end="")
    os.replace(tmp, out)
    _ccache.library_written()
    return out


def build(source, verbose=False, defines=()):
    """Compile ``source`` (when its library is not built yet) and return
    the library's path."""
    out, pending = _start(source, verbose, defines)
    return _finish(source, out, pending, verbose)


def build_all(sources, verbose=False):
    """Compile every source at once, one ``nvcc`` each; an entry is a
    path or ``(path, defines)``.  Returns ``{entry: (library path,
    seconds until it was ready)}``."""
    t0 = time.perf_counter()
    started = [(s,) + _start(*((s, verbose) if isinstance(s, str)
                               else (s[0], verbose, s[1])))
               for s in sources]
    done = {}
    try:
        for source, out, pending in started:
            path = source if isinstance(source, str) else source[0]
            done[source] = (_finish(path, out, pending, verbose),
                            time.perf_counter() - t0)
    finally:
        for _, _, pending in started:
            if pending is not None and pending[0].poll() is None:
                pending[0].kill()
                pending[0].wait()
    return done


def load(source, bind):
    """The ``ctypes`` library built from ``source``, built and bound on
    first use; ``bind(lib)`` sets the argument and result types."""
    with _libs_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            bind(lib)
            _libs[source] = lib
    return lib
