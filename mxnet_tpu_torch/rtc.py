"""``mx.rtc`` — user kernels launched on NDArrays (K5 of the port).

Reference: MXNet 1.x's ``mx.rtc.CudaModule`` (``include/mxnet/rtc.h``,
``src/common/rtc.cc``), which compiles user CUDA source with NVRTC and
launches it on NDArrays.  The JAX package replaces CUDA source with a
Pallas body (``mxnet_tpu/rtc.py::PallasKernel.launch``, its K5) and
stubs ``CudaModule`` to raise.  On the card the port gives MXNet's own
contract back:

* ``CudaModule(source, options=(), exports=())`` compiles ``source``
  once with NVRTC for ``sm_90a`` (``-std=c++17``, the CUDA home's
  ``include/`` on the include path, so ``cuda_bf16.h`` resolves) and
  keeps the CUBIN in memory, and in the compile cache
  (``compile_cache``: keyed by a hash of the source, the options, the
  architecture and NVRTC's version; ``cached`` says whether this module
  came from it, without a compile); it is loaded into a device's primary
  context at the first launch there.  ``exports`` are C++ name
  expressions (``"scale<float>"``) resolved to their mangled names;
  ``extern "C"`` kernels need none.
* ``get_kernel(name, signature)`` parses MXNet 1.x's signature string
  (``"const float *x, const float *y, float *out, int n"``) into pointer
  and scalar arguments with their const-ness and type.
* ``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  is MXNet 1.x's in-place contract: it checks each NDArray's dtype
  against its pointer type and that it is contiguous on ``ctx``, pushes
  through the engine with the const pointers as read vars and the others
  as write vars, and launches with ``cuLaunchKernel`` on torch's current
  stream, so it is ordered with the torch ops before and after it and
  never synchronizes.  Dynamic shared memory above 48 KB is allowed
  through ``cuFuncSetAttribute`` first.  ``launches`` counts launches.

Failures raise ``MXNetError`` and never run something else instead: a
``CudaModule`` without CUDA, a failed compile (with NVRTC's log), a
failed ``cuLaunchKernel`` (with ``cuGetErrorString``).  A launch writes
its non-const arrays in place; writing into an array that a recorded
graph computed would corrupt that graph, so that raises too (inside
``autograd.Function`` the outputs are allocated under ``pause()``, which
is safe).  The engine poisons the write vars of a launch that fails on
the host.  A fault inside a user kernel (a bad address, a trap) is
asynchronous: it surfaces at the next synchronization of the stream,
not at ``launch``; the port adds no synchronization per launch to hide
that.  There is no automatic gradient through a user kernel: write an
``autograd.Function`` whose backward launches a second kernel.

``PallasKernel``/``PallasModule`` keep the JAX package's names and
contract (``launch(*arrays)`` returns new NDArrays of ``out_shape``, via
``ops.registry.invoke_fn``).  The port runs a Python body the way the
JAX package does off the TPU: interpreted, over tensor "refs" (whole
arrays, or a ``grid`` of ``BlockSpec(block_shape, index_map)`` blocks;
inside a body :func:`program_id` gives the grid position).  It is the
plain version of K5.  ``interpret`` defaults to true for CPU arrays only;
arrays on the card need ``interpret=True``.  Its backward raises, as the
JAX package's does.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import re
import threading
import time

import torch

from . import compile_cache as _ccache
from .base import MXNetError
from .context import as_context
from .engine import Engine
from .ops import _nvrtc
from .ops import registry as _reg
from .ops._build import cuda_home
from .ops.tensor import to_torch_dtype

_ARCH = "sm_90a"
_STATIC_SHARED_LIMIT = 48 * 1024


# -- PallasKernel: the interpreted plain version ----------------------------

class ShapeDtypeStruct:
    """``out_shape`` entry: a shape and a dtype (the port's stand-in for
    ``jax.ShapeDtypeStruct``; any object with ``.shape`` and ``.dtype``
    serves)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


class BlockSpec:
    """The block of an array each grid step sees: ``block_shape`` (an
    entry None squeezes that axis to one element) at the block indices
    ``index_map(*grid position)``."""

    def __init__(self, block_shape=None, index_map=None):
        self.block_shape = None if block_shape is None else \
            tuple(block_shape)
        self.index_map = index_map


_grid_pos = threading.local()


def program_id(axis):
    """Inside an interpreted body: this grid step's index on ``axis``."""
    return _grid_pos.value[axis]


def num_programs(axis):
    """Inside an interpreted body: the grid's extent on ``axis``."""
    return _grid_pos.grid[axis]


def _block(t, spec, pos):
    if spec is None or spec.block_shape is None:
        return t
    idx = spec.index_map(*pos) if spec.index_map is not None else \
        (0,) * len(spec.block_shape)
    idx = idx if isinstance(idx, tuple) else (idx,)
    key = []
    for b, size in zip(idx, spec.block_shape):
        b = int(b)
        key.append(b if size is None else slice(b * size, (b + 1) * size))
    return t[tuple(key)]


class _PallasFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, *datas):
        ctx.kernel_name = kernel._name
        return tuple(kernel._interpret_body(datas))

    @staticmethod
    def backward(ctx, *cts):
        raise MXNetError(
            "PallasKernel %r has no gradient: write an autograd.Function "
            "whose backward launches a kernel of its own" % ctx.kernel_name)


class PallasKernel:
    """A Python kernel body launched on NDArrays (parity: the JAX
    package's ``rtc.PallasKernel``), run by the interpreter."""

    def __init__(self, kernel_fn, out_shape, in_specs=None, out_specs=None,
                 grid=None, name=None, interpret=None, **pallas_kwargs):
        self._kernel_fn = kernel_fn
        self._name = name or getattr(kernel_fn, "__name__", "pallas_kernel")
        if pallas_kwargs:
            raise MXNetError(
                "PallasKernel %r: %s not supported by the port's "
                "interpreter (it takes grid, in_specs and out_specs)"
                % (self._name, ", ".join(sorted(pallas_kwargs))))
        if interpret is False:
            raise MXNetError(
                "PallasKernel %r: a Python body has no compiled form in the "
                "port; write it in CUDA C++ and launch it with "
                "mx.rtc.CudaModule" % self._name)
        self._multi = isinstance(out_shape, (tuple, list))
        self._out_shape = list(out_shape) if self._multi else [out_shape]
        self._in_specs = in_specs
        self._out_specs = out_specs
        self._grid = None if grid is None else (
            tuple(grid) if isinstance(grid, (tuple, list)) else (grid,))
        self._interpret = interpret

    def _check_devices(self, arrays):
        if self._interpret:
            return
        for a in arrays:
            if a._data.device.type != "cpu":
                raise MXNetError(
                    "PallasKernel %r was given an array on %s: a Python "
                    "body runs interpreted on CPU arrays by default; pass "
                    "interpret=True to interpret it on the card, or launch "
                    "a CUDA kernel with mx.rtc.CudaModule"
                    % (self._name, a._data.device))

    def _specs(self, specs, n):
        if specs is None:
            return [None] * n
        if isinstance(specs, (tuple, list)):
            return list(specs)
        return [specs] * n

    def _interpret_body(self, datas):
        dev = datas[0].device if datas else torch.device("cpu")
        outs = [torch.zeros(tuple(s.shape), dtype=to_torch_dtype(s.dtype),
                            device=dev) for s in self._out_shape]
        ins = [d.detach() for d in datas]
        if self._grid is None:
            self._kernel_fn(*ins, *outs)
            return outs
        in_specs = self._specs(self._in_specs, len(ins))
        out_specs = self._specs(self._out_specs, len(outs))
        _grid_pos.grid = self._grid
        for pos in itertools.product(*(range(g) for g in self._grid)):
            _grid_pos.value = pos
            refs = [_block(t, s, pos) for t, s in zip(ins, in_specs)]
            refs += [_block(t, s, pos) for t, s in zip(outs, out_specs)]
            self._kernel_fn(*refs)
        return outs

    def launch(self, *arrays):
        """Run on NDArrays; returns the output NDArray(s).  Recorded
        inside ``autograd.record()``, but a backward through it raises."""
        self._check_devices(arrays)
        results = _reg.invoke_fn(
            lambda *datas: _PallasFn.apply(self, *datas), list(arrays),
            op_name=self._name)
        return results if self._multi else results[0]

    __call__ = launch


class PallasModule:
    """Named collection of Pallas kernels (parity: CudaModule)."""

    def __init__(self, **kernels):
        self._kernels = dict(kernels)

    def get_kernel(self, name, *args, **kwargs):
        k = self._kernels.get(name)
        if k is None:
            raise MXNetError("no kernel %r in module" % name)
        return k


# -- CudaModule / CudaKernel: K5 ------------------------------------------

# C++ type of a pointer argument -> torch dtype (None: any)
_POINTER_TYPES = {
    "void": None, "float": torch.float32, "double": torch.float64,
    "half": torch.float16, "__half": torch.float16,
    "__nv_bfloat16": torch.bfloat16, "nv_bfloat16": torch.bfloat16,
    "char": torch.int8, "signed char": torch.int8, "int8_t": torch.int8,
    "unsigned char": torch.uint8, "uint8_t": torch.uint8,
    "short": torch.int16, "int16_t": torch.int16,
    "int": torch.int32, "int32_t": torch.int32,
    "unsigned": torch.uint32, "unsigned int": torch.uint32,
    "uint32_t": torch.uint32,
    "long long": torch.int64, "long long int": torch.int64,
    "int64_t": torch.int64, "bool": torch.bool,
}
# C++ type of a scalar argument -> the ctypes type it is passed as
_SCALAR_TYPES = {
    "float": ctypes.c_float, "double": ctypes.c_double,
    "char": ctypes.c_int8, "signed char": ctypes.c_int8,
    "int8_t": ctypes.c_int8, "unsigned char": ctypes.c_uint8,
    "uint8_t": ctypes.c_uint8, "short": ctypes.c_int16,
    "int16_t": ctypes.c_int16, "int": ctypes.c_int32,
    "int32_t": ctypes.c_int32, "unsigned": ctypes.c_uint32,
    "unsigned int": ctypes.c_uint32, "uint32_t": ctypes.c_uint32,
    "long long": ctypes.c_int64, "long long int": ctypes.c_int64,
    "int64_t": ctypes.c_int64, "unsigned long long": ctypes.c_uint64,
    "uint64_t": ctypes.c_uint64, "size_t": ctypes.c_uint64,
    "bool": ctypes.c_bool,
}
_QUALIFIERS = ("const", "__restrict__", "restrict", "volatile")


class KernelArg:
    """One parsed argument of a kernel signature."""

    __slots__ = ("name", "ctype", "pointer", "const", "dtype", "scalar")

    def __init__(self, name, ctype, pointer, const):
        self.name = name
        self.ctype = ctype
        self.pointer = pointer
        self.const = const
        self.dtype = _POINTER_TYPES[ctype] if pointer else None
        self.scalar = None if pointer else _SCALAR_TYPES[ctype]

    def __repr__(self):
        return "%s%s%s %s" % ("const " if self.const else "", self.ctype,
                              " *" if self.pointer else "", self.name)


def parse_signature(signature):
    """MXNet 1.x's kernel signature string → a list of ``KernelArg``."""
    args = []
    for i, param in enumerate(signature.split(",")):
        tokens = re.findall(r"\*|[A-Za-z_]\w*", param)
        if not tokens or re.sub(r"[\s\w*]", "", param):
            raise MXNetError("kernel signature %r: cannot parse argument "
                             "%d (%r)" % (signature, i, param.strip()))
        stars = tokens.count("*")
        if stars > 1:
            raise MXNetError("kernel signature %r: argument %d is a pointer "
                             "to a pointer" % (signature, i))
        const = "const" in tokens
        if stars:
            at = tokens.index("*")
            left = [t for t in tokens[:at] if t not in _QUALIFIERS]
            right = [t for t in tokens[at + 1:] if t not in _QUALIFIERS]
            ctype, name = " ".join(left), (right[-1] if right else
                                           "arg%d" % i)
            table = _POINTER_TYPES
        else:
            words = [t for t in tokens if t not in _QUALIFIERS]
            ctype, name = " ".join(words), "arg%d" % i
            if ctype not in _SCALAR_TYPES and len(words) > 1:
                ctype, name = " ".join(words[:-1]), words[-1]
            table = _SCALAR_TYPES
        if ctype not in table:
            raise MXNetError(
                "kernel signature %r: argument %d has type %r, which the "
                "port does not launch with (%s)" % (
                    signature, i, ctype + (" *" if stars else ""),
                    ", ".join(sorted(table))))
        args.append(KernelArg(name, ctype, bool(stars), const))
    return args


def _dims(dims, what):
    dims = tuple(int(d) for d in (dims if isinstance(dims, (tuple, list))
                                  else (dims,)))
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("%s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def compile_options(options=()):
    """NVRTC options of every ``CudaModule``, then the user's."""
    return ["--gpu-architecture=%s" % _ARCH, "-std=c++17",
            "--include-path=%s" % os.path.join(cuda_home(), "include")] \
        + list(options)


class CudaModule:
    """User CUDA C++ compiled by NVRTC (parity: MXNet 1.x
    ``mx.rtc.CudaModule``)."""

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule needs CUDA, which is not "
                             "available here (a Python body runs on the "
                             "host through mx.rtc.PallasKernel)")
        self.exports = tuple(exports)
        self.options = compile_options(options)
        key = _ccache.cubin_key(source, "mxnet_rtc.cu", self.options,
                                self.exports, _ARCH, _nvrtc.version())
        got = _ccache.cubin_get(key)
        self.cached = got is not None
        if self.cached:
            (self.cubin, self._lowered), self.log = got, ""
        else:
            t0 = time.perf_counter()
            self.cubin, self._lowered, self.log = _nvrtc.compile_program(
                source, "mxnet_rtc.cu", self.options, self.exports)
            _ccache.cubin_put(key, self.cubin, self._lowered,
                              time.perf_counter() - t0)
        self._modules = {}
        self._lock = threading.Lock()

    def _module(self, ordinal):
        mod = self._modules.get(ordinal)
        if mod is None:
            with self._lock:
                mod = self._modules.get(ordinal)
                if mod is None:
                    mod = _nvrtc.load_module(self.cubin, ordinal)
                    self._modules[ordinal] = mod
        return mod

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``exports`` entry or an ``extern "C"``
        name) with MXNet 1.x's ``signature`` string."""
        return CudaKernel(self, name, self._lowered.get(name, name),
                          signature)


class CudaKernel:
    """A kernel of a ``CudaModule`` (parity: MXNet 1.x ``CudaKernel``)."""

    def __init__(self, module, name, lowered, signature):
        self.module = module
        self.name = name
        self.lowered = lowered
        self.signature = signature
        self.args = parse_signature(signature)
        self.launches = 0
        self._functions = {}
        self._smem = {}

    def _function(self, ordinal, shared_mem):
        fn = self._functions.get(ordinal)
        if fn is None:
            fn = _nvrtc.get_function(self.module._module(ordinal),
                                     self.lowered, ordinal)
            self._functions[ordinal] = fn
        if shared_mem > max(self._smem.get(ordinal, 0),
                            _STATIC_SHARED_LIMIT):
            _nvrtc.set_max_dynamic_shared(fn, shared_mem, ordinal)
            self._smem[ordinal] = shared_mem
        return fn

    def pack(self, args, dev):
        """Check ``args`` against the signature and build the argument
        array.  Returns ``(params, keep, read arrays, write arrays)``:
        ``params`` is the ``void*[]`` of argument addresses, ``keep`` the
        ctypes values it points at (both must outlive the launch)."""
        from .ndarray.ndarray import NDArray

        if len(args) != len(self.args):
            raise MXNetError("kernel %s takes %d arguments (%s), got %d"
                             % (self.name, len(self.args), self.signature,
                                len(args)))
        keep, reads, writes = [], [], []
        for spec, a in zip(self.args, args):
            if not spec.pointer:
                if isinstance(a, NDArray):
                    raise MXNetError("kernel %s: argument %r is a scalar, "
                                     "got an NDArray" % (self.name, spec))
                keep.append(spec.scalar(a))
                continue
            if not isinstance(a, NDArray):
                raise MXNetError("kernel %s: argument %r needs an NDArray, "
                                 "got %s" % (self.name, spec, type(a)))
            t = a._data
            if spec.dtype is not None and t.dtype != spec.dtype:
                raise MXNetError("kernel %s: argument %r needs %s, got %s"
                                 % (self.name, spec, spec.dtype, t.dtype))
            if t.device != dev:
                raise MXNetError("kernel %s: argument %r is on %s, the "
                                 "launch on %s" % (self.name, spec,
                                                   t.device, dev))
            if not t.is_contiguous():
                raise MXNetError("kernel %s: argument %r must be "
                                 "contiguous" % (self.name, spec))
            if spec.const:
                reads.append(a)
            else:
                if t.grad_fn is not None:
                    raise MXNetError(
                        "kernel %s writes argument %r in place, but that "
                        "array was computed in a recorded graph; allocate "
                        "the output under autograd.pause()"
                        % (self.name, spec))
                writes.append(a)
            keep.append(ctypes.c_void_p(t.data_ptr()))
        params = (ctypes.c_void_p * len(keep))(
            *[ctypes.addressof(v) for v in keep])
        return params, keep, reads, writes

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a gpu context) over ``args``, in place.
        The open bulk segment flushes first: a launch is never
        deferred."""
        Engine.get().flush_bulk("rtc:%s" % self.name)
        dev = as_context(ctx).torch_device
        if dev.type != "cuda":
            raise MXNetError("CudaKernel %s launches on a gpu context, got "
                             "%s" % (self.name, ctx))
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        params, keep, reads, writes = self.pack(args, dev)
        ordinal = dev.index or 0
        fn = self._function(ordinal, int(shared_mem))

        def run():
            stream = torch.cuda.current_stream(dev).cuda_stream
            _nvrtc.launch(fn, grid, block, shared_mem, stream, params,
                          ordinal)
            self.launches += 1

        Engine.get().push(run, tuple(a._var for a in reads),
                          tuple(a._var for a in writes),
                          op_name=self.name, device=dev)
        for a in writes:
            # the raw-pointer write is invisible to torch: bump the
            # tensor's version so a graph that saved it refuses backward
            torch.autograd.graph.increment_version(a._data)

