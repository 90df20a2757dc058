"""``ctypes`` bindings of NVRTC and of the CUDA driver API.

``mx.rtc.CudaModule`` compiles user CUDA C++ at run time with NVRTC and
launches it through the driver API; this module is the thin layer under
it.  Both libraries load lazily, on the first call that needs them, and
never when the package is imported:

* ``libnvrtc`` is looked for under the CUDA home that ``ops/_build.py``
  uses for ``nvcc`` (``$CUDA_HOME``, ``$CUDA_PATH``, else
  ``/usr/local/cuda``; ``lib64/`` then ``lib/``), then by the loader's
  own search.
* ``libcuda.so.1`` is the driver's library.

Every call checks its status and raises ``MXNetError`` with NVRTC's or
the driver's own error string.

Torch creates the device's primary context lazily, on the thread that
first touches CUDA; driver calls from another thread (torch runs
backward on its own threads) would fail with
``CUDA_ERROR_INVALID_CONTEXT``.  :func:`make_current` retains the primary
context of a device once and makes it current on the calling thread
before every module load and launch.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import threading

from ..base import MXNetError
from ._build import cuda_home

CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_lock = threading.Lock()
_nvrtc = None
_cuda = None
_primary = {}     # device ordinal -> CUcontext (retained once)


def _nvrtc_candidates():
    home = cuda_home()
    found = []
    for sub in ("lib64", "lib", os.path.join("targets", "x86_64-linux",
                                             "lib")):
        found += sorted(glob.glob(os.path.join(home, sub, "libnvrtc.so*")))
    name = ctypes.util.find_library("nvrtc")
    if name:
        found.append(name)
    return found


def _bind_nvrtc(lib):
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    cp = ctypes.c_char_p
    sigs = {
        "nvrtcVersion": [ctypes.POINTER(i), ctypes.POINTER(i)],
        "nvrtcCreateProgram": [ctypes.POINTER(p), cp, cp, i,
                               ctypes.POINTER(cp), ctypes.POINTER(cp)],
        "nvrtcDestroyProgram": [ctypes.POINTER(p)],
        "nvrtcAddNameExpression": [p, cp],
        "nvrtcCompileProgram": [p, i, ctypes.POINTER(cp)],
        "nvrtcGetProgramLogSize": [p, ctypes.POINTER(s)],
        "nvrtcGetProgramLog": [p, ctypes.POINTER(ctypes.c_char)],
        "nvrtcGetCUBINSize": [p, ctypes.POINTER(s)],
        "nvrtcGetCUBIN": [p, ctypes.POINTER(ctypes.c_char)],
        "nvrtcGetLoweredName": [p, cp, ctypes.POINTER(cp)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.nvrtcGetErrorString.argtypes = [i]
    lib.nvrtcGetErrorString.restype = cp


def _bind_cuda(lib):
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    sigs = {
        "cuInit": [u],
        "cuDeviceGet": [ctypes.POINTER(i), i],
        "cuDevicePrimaryCtxRetain": [ctypes.POINTER(p), i],
        "cuCtxGetCurrent": [ctypes.POINTER(p)],
        "cuCtxSetCurrent": [p],
        "cuModuleLoadData": [ctypes.POINTER(p), ctypes.c_char_p],
        "cuModuleGetFunction": [ctypes.POINTER(p), p, ctypes.c_char_p],
        "cuFuncSetAttribute": [p, i, i],
        "cuLaunchKernel": [p, u, u, u, u, u, u, u, p,
                           ctypes.POINTER(p), ctypes.POINTER(p)],
        "cuGetErrorString": [i, ctypes.POINTER(ctypes.c_char_p)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i


def nvrtc():
    """The NVRTC library, loaded and bound on first use."""
    global _nvrtc
    with _lock:
        if _nvrtc is None:
            errors = []
            for cand in _nvrtc_candidates():
                try:
                    lib = ctypes.CDLL(cand)
                    _bind_nvrtc(lib)
                except (OSError, AttributeError) as e:
                    errors.append("%s: %s" % (cand, e))
                    continue
                _nvrtc = lib
                break
            else:
                raise MXNetError(
                    "libnvrtc not found under %s (lib64, lib) or by the "
                    "loader%s" % (cuda_home(), "".join(
                        "\n  " + e for e in errors)))
    return _nvrtc


def driver():
    """The CUDA driver library, loaded, bound and initialized on first
    use."""
    global _cuda
    with _lock:
        if _cuda is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError("the CUDA driver (libcuda.so.1) did not "
                                 "load: %s" % e) from e
            _bind_cuda(lib)
            _check(lib, lib.cuInit(0), "cuInit")
            _cuda = lib
    return _cuda


def _check(lib, status, what):
    if status != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(status, ctypes.byref(msg))
        raise MXNetError("%s failed: CUDA error %d (%s)" % (
            what, status, (msg.value or b"unknown").decode()))


def check(status, what):
    """Raise ``MXNetError`` with ``cuGetErrorString`` unless ``status``
    is ``CUDA_SUCCESS``."""
    if status != 0:
        _check(driver(), status, what)


def _nvrtc_check(status, what):
    if status != 0:
        msg = nvrtc().nvrtcGetErrorString(status).decode()
        raise MXNetError("%s failed: %s" % (what, msg))


def version():
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(nvrtc().nvrtcVersion(ctypes.byref(major),
                                      ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def compile_program(source, name, options, name_expressions=()):
    """Compile ``source`` to a CUBIN.  Returns ``(cubin bytes, {name
    expression: lowered name}, log)``; a failed compile raises
    ``MXNetError`` carrying NVRTC's log."""
    lib = nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _nvrtc_check(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         "nvrtcAddNameExpression(%s)" % expr)
        opts = [o.encode() for o in options]
        arr = (ctypes.c_char_p * len(opts))(*opts)
        status = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(max(size.value, 1))
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if status != 0:
            raise MXNetError("NVRTC failed to compile %s (%s):\n%s" % (
                name, lib.nvrtcGetErrorString(status).decode(), log))
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _nvrtc_check(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(out)),
                         "nvrtcGetLoweredName(%s)" % expr)
            lowered[expr] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def make_current(ordinal):
    """Make device ``ordinal``'s primary context current on this thread
    (retaining it on first use).  Returns the driver library."""
    lib = driver()
    ctx = _primary.get(ordinal)
    if ctx is None:
        with _lock:
            ctx = _primary.get(ordinal)
            if ctx is None:
                dev = ctypes.c_int()
                check(lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                      "cuDeviceGet")
                ctx = ctypes.c_void_p()
                check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      "cuDevicePrimaryCtxRetain")
                _primary[ordinal] = ctx
    cur = ctypes.c_void_p()
    check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return lib


def load_module(cubin, ordinal):
    """Load a CUBIN into device ``ordinal``'s primary context."""
    lib = make_current(ordinal)
    mod = ctypes.c_void_p()
    check(lib.cuModuleLoadData(ctypes.byref(mod), cubin), "cuModuleLoadData")
    return mod


def get_function(module, name, ordinal):
    lib = make_current(ordinal)
    fn = ctypes.c_void_p()
    check(lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode()),
          "cuModuleGetFunction(%s)" % name)
    return fn


def set_max_dynamic_shared(function, nbytes, ordinal):
    lib = make_current(ordinal)
    check(lib.cuFuncSetAttribute(
        function, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
        int(nbytes)), "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(function, grid, block, shared_mem, stream, params, ordinal):
    """``cuLaunchKernel`` on ``stream`` (a ``cudaStream_t`` as an int).
    ``params`` is the ``void*[]`` of argument addresses; the caller keeps
    it and its targets alive until this returns."""
    lib = make_current(ordinal)
    check(lib.cuLaunchKernel(function, grid[0], grid[1], grid[2], block[0],
                             block[1], block[2], int(shared_mem),
                             ctypes.c_void_p(stream), params, None),
          "cuLaunchKernel")
