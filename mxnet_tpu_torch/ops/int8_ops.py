"""O5 ``int8_gemm`` and O6 ``int8_conv``: the port-only int8 x int8 ->
int32 products behind the quantized ops and layers.

No Pallas kernel stands behind them.  The JAX package hands its int8
contractions to XLA with ``preferred_element_type=int32`` (the MXU's int8
mode): ``mxnet_tpu/ops/quantized_ops.py``'s ``_quantized_fc`` and
``_quantized_conv``, and ``mxnet_tpu/contrib/quantization.py``'s
``QuantizedDense`` and ``QuantizedConv2D``, whose ``fn(raw)`` quantizes
the f32 activation, contracts and dequantizes as one computation.  Torch
has no int8 convolution on CUDA, so both are CUDA C++ in
``csrc/int8_ops.cu`` (built by ``ops/_build.py`` at first use); O5 is O6
at 1 x 1 x 1 x 1.

- ``int8_gemm(a, b)``: ``a`` (M, K), ``b`` (N, K) s8 (K-contiguous, as
  ``dot_general`` contracts ``(ndim-1, 1)``) give (M, N).
- ``int8_conv(x, w, ...)``: ``x`` (N, H, W, C) channels-last, ``w``
  (O, KH, KW, C / groups) s8 (OHWI) give (N, P, Q, O), with stride, zero
  padding, dilation and groups.

Two A modes: ``a``/``x`` s8 (the registered ops), or, with ``scale``,
the layer's f32 activation, which the kernel quantizes as it loads it,
``clip(rint(x * f32(scale)), -127, 127)`` (``quantize_int8``'s rule), in
any strides (a channel-first layer passes its NCHW input permuted, a
view).  Two epilogues: ``denom=None`` gives the s32 sums plus an s32
``bias`` (the registered ops' accumulator and rounded bias), a float
``denom`` gives f32 ``f32(acc) / denom + bias`` with an f32 ``bias``
(the layers' dequantize), each operation rounded once.  Sums are exact
and the epilogue is correctly rounded, so the kernels equal their plain
versions (``int8_gemm_ref``, ``int8_conv_ref``, after ``quantize_int8``
in the f32 mode) bit for bit.  A CPU tensor runs the plain version; a
CUDA tensor launches a kernel or raises: nothing falls back.

Routes (``route_for``): ``wgmma``, the Hopper design, takes every f32-mode
call and s8 calls whose C/G is a multiple of 16 with 16-byte aligned
operands; ``mma_sync``, the first design, takes depthwise convolutions
(in the f32 mode after ``quantize_int8``) and the other s8 calls (its
byte path).  ``plan_wgmma`` splits K across blocks where the tiles are
fewer than the SMs.  Launches go on the current stream, so a captured
graph replays them; ``int8_gemm.launches`` and ``int8_conv.launches``
count every call that launches, and ``<wrapper>.<route>_<mode>``
(``wgmma_f32``, ``wgmma_s8``, ``mma_sync_f32``, ``mma_sync_s8``) each
route and mode (``graph_cache.count``, replays included).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build

_SOURCE = _build.source_path("int8_ops.cu")
_EPI_S32, _EPI_F32 = 0, 1
_A_S8, _A_F32_VEC, _A_F32_ANY = 0, 1, 2
ROUTES = ("wgmma", "mma_sync")
MODES = ("f32", "s8")
_WG_BM, _WG_BK = 128, 128      # the wgmma route's tile rows and K bytes
MAX_SPLITS = 16


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the four pointers, the 16 shape ints and the epilogue, denom, stream
    lib.mxtt_int8_conv.argtypes = [p] * 4 + [i] * 17 + [f, p]
    lib.mxtt_int8_conv.restype = i
    lib.mxtt_int8_gemm.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.mxtt_int8_gemm.restype = i
    ll = ctypes.c_longlong
    # x, its mode and scale and four strides; wt, out, ws, bias; the 16
    # shape ints; bn, splits, the epilogue, denom, stream
    lib.mxtt_int8_conv_wgmma.argtypes = [p, i, f] + [ll] * 4 + [p] * 4 \
        + [i] * 16 + [i, i, i, f, p]
    lib.mxtt_int8_conv_wgmma.restype = i
    lib.mxtt_int8_error_string.argtypes = [i]
    lib.mxtt_int8_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def quantize_int8(x, scale):
    """``clip(round(x * f32(scale)), -127, 127)`` as int8: the product in
    f32 (a number ``scale`` rounded to f32 first, a tensor as it is),
    rounded half to even.  The registered ops' quantize, the f32 mode's
    plain version, and the f32 mode's quantize on the ``mma_sync``
    route."""
    s = scale if isinstance(scale, torch.Tensor) \
        else float(np.float32(scale))
    return torch.clamp(torch.round(x * s), -127, 127).to(torch.int8)


def conv_out_size(size, k, stride, pad, dilate):
    """An output extent of a convolution (floor, as XLA's and cuDNN's)."""
    return (size + 2 * pad - dilate * (k - 1) - 1) // stride + 1


def _epilogue(acc, bias, denom):
    """The plain epilogue on the s32 sums ``acc`` (channels last)."""
    if denom is None:
        return acc if bias is None else acc + bias
    out = acc.to(torch.float32) / acc.new_full((), denom,
                                               dtype=torch.float32)
    return out if bias is None else out + bias


def int8_gemm_ref(a, b, bias=None, denom=None):
    """The plain version of O5: ``a`` (M, K) s8 times ``b`` (N, K) s8 in
    float64 (exact), then the epilogue."""
    acc = torch.round(a.to(torch.float64) @ b.to(torch.float64).t())
    return _epilogue(acc.to(torch.int32), bias, denom)


def int8_conv_ref(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                  num_group=1, bias=None, denom=None):
    """The plain version of O6: the convolution of ``x`` (N, H, W, C) s8
    by ``w`` (O, KH, KW, C / groups) s8 in float64 (exact), channels
    last, then the epilogue."""
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64), None,
                   tuple(stride), tuple(pad), tuple(dilate), int(num_group))
    acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()
    return _epilogue(acc, bias, denom)


def _check_bias(bias, n, denom, dev):
    if bias is None:
        return None
    want = torch.int32 if denom is None else torch.float32
    if bias.dtype != want or tuple(bias.shape) != (n,) \
            or bias.device != dev:
        raise MXNetError("the int8 kernels take a bias (%d,) %s on %s, got "
                         "%s %s on %s" % (n, want, dev, tuple(bias.shape),
                                          bias.dtype, bias.device))
    return bias.contiguous()


def _operand(t, what, dim, scale=None):
    """An s8 operand made contiguous, or with ``scale`` an f32 activation
    as it is (the kernel takes its strides)."""
    if scale is not None:
        if not t.is_floating_point() or t.dim() != dim:
            raise MXNetError("int8 kernels: with a scale, %s must be a "
                             "%d-d float tensor, got %s %s"
                             % (what, dim, tuple(t.shape), t.dtype))
        if t.device.type == "cuda" and t.dtype != torch.float32:
            raise MXNetError("int8 kernels: the f32 mode takes float32 %s on "
                             "the card, got %s" % (what, t.dtype))
        return t
    if t.dtype != torch.int8 or t.dim() != dim:
        raise MXNetError("int8 kernels: %s must be a %d-d int8 tensor, got "
                         "%s %s" % (what, dim, tuple(t.shape), t.dtype))
    return t.contiguous()


def _raise(lib, err, what):
    if err != 0:
        raise MXNetError("%s kernel launch failed: %d (%s)"
                         % (what, err, lib.mxtt_int8_error_string(err)
                            .decode()))


_sms = {}


def _sm_count(dev):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _sms[idx]


def route_for(f32, cg, groups, x_ptr, w_ptr):
    """The route of one call: ``"mma_sync"`` for a depthwise convolution
    (one channel a group) and for s8 operands the wgmma route does not
    take (C/G not a multiple of 16, a pointer not 16-byte aligned),
    ``"wgmma"`` otherwise."""
    if groups > 1 and cg == 1:
        return "mma_sync"
    if f32 or (cg % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0):
        return "wgmma"
    return "mma_sync"


def plan_wgmma(m, og, groups, k, sms):
    """``(bn, splits)`` of the wgmma route: the tile's width (64, 128, or
    256 above 1,024 rows) and the K splits, so that a grid of fewer tiles
    than ``sms`` SMs spreads its K tiles over about ``sms`` blocks (at
    most MAX_SPLITS, each split at least one K tile)."""
    if og <= 64:
        bn = 64
    elif og <= 128 or m <= 1024:
        bn = 128
    else:
        bn = 256
    tiles = -(-m // _WG_BM) * -(-og // bn) * groups
    ktiles = -(-k // _WG_BK)
    if tiles >= sms or ktiles < 2:
        return bn, 1
    want = min(ktiles, -(-sms // tiles), MAX_SPLITS)
    kper = -(-ktiles // want)
    return bn, -(-ktiles // kper)


def _a_mode(x, cg):
    """The f32 A mode: 16 channels a chunk where C/G is a multiple of 16,
    channels are contiguous and every chunk is 16-byte aligned; element
    by element otherwise."""
    st = x.stride()
    if cg % 16 == 0 and st[3] == 1 and x.data_ptr() % 16 == 0 \
            and all(v % 4 == 0 for v in st[:3]):
        return _A_F32_VEC
    return _A_F32_ANY


def _count(fn, route, mode):
    _graph_cache.count(fn, "launches")
    _graph_cache.count(fn, "%s_%s" % (route, mode))


def _conv_launch(fn, what, x, w, out, bias, geom, groups, denom, scale):
    """Launch O6's route for ``x`` (n, h, w, c) (s8, or f32 with
    ``scale``) into ``out``; ``geom`` is (p, q, sh, sw, ph, pw, dh, dw)."""
    n, h, wd, c = x.shape
    o, kh, kw, cg = w.shape
    f32 = scale is not None
    route = route_for(f32, cg, groups, x.data_ptr(), w.data_ptr())
    epi = _EPI_S32 if denom is None else _EPI_F32
    den = 0.0 if denom is None else float(denom)
    bptr = None if bias is None else bias.data_ptr()
    dev = x.device
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "mma_sync":
            xq = quantize_int8(x, scale).contiguous() if f32 else x
            err = lib.mxtt_int8_conv(
                xq.data_ptr(), w.data_ptr(), out.data_ptr(), bptr, n, h, wd,
                c, o, kh, kw, *geom, groups, epi, den, stream)
        else:
            m = n * geom[0] * geom[1]
            bn, splits = plan_wgmma(m, o // groups, groups, kh * kw * cg,
                                    _sm_count(dev))
            ws = None if splits == 1 else torch.empty(
                splits * m * o, device=dev, dtype=torch.int32)
            mode = _a_mode(x, cg) if f32 else _A_S8
            err = lib.mxtt_int8_conv_wgmma(
                x.data_ptr(), mode,
                float(np.float32(scale)) if f32 else 0.0, *x.stride(),
                w.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), bptr, n, h, wd, c, o,
                kh, kw, *geom, groups, bn, splits, epi, den, stream)
    _raise(lib, err, what)
    _count(fn, route, "f32" if f32 else "s8")


def int8_gemm(a, b, bias=None, denom=None, scale=None):
    """O5: ``a`` (M, K) times ``b`` (N, K) s8 over K; ``a`` s8, or with
    ``scale`` f32, quantized as it loads (see the module docstring for
    the modes and epilogues).  CPU tensors run the plain version; CUDA
    tensors launch a kernel or raise."""
    a, b = _operand(a, "a", 2, scale), _operand(b, "b", 2)
    if a.shape[1] != b.shape[1]:
        raise MXNetError("int8_gemm: K differs: %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    dev = a.device
    if b.device != dev:
        raise MXNetError("int8_gemm: operands on %s and %s"
                         % (dev, b.device))
    bias = _check_bias(bias, b.shape[0], denom, dev)
    if dev.type == "cpu":
        if scale is not None:
            a = quantize_int8(a, scale)
        return int8_gemm_ref(a, b, bias, denom)
    if dev.type != "cuda":
        raise MXNetError("int8_gemm runs on cuda or cpu tensors, got %s"
                         % dev)
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty(m, n, device=dev, dtype=torch.int32 if denom is None
                      else torch.float32)
    if m == 0 or n == 0:
        return out
    # (M, K) as (M, 1, 1, K): a's row stride is the image stride
    x = a.as_strided((m, 1, 1, k), (a.stride(0), 0, 0, a.stride(1)))
    _conv_launch(int8_gemm, "int8_gemm", x, b.view(n, 1, 1, k), out, bias,
                 (1, 1, 1, 1, 0, 0, 1, 1), 1, denom, scale)
    return out


int8_gemm.launches = 0


def int8_conv(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_group=1,
              bias=None, denom=None, scale=None):
    """O6: ``x`` (N, H, W, C) convolved by ``w`` (O, KH, KW, C /
    ``num_group``) s8 into (N, P, Q, O), channels last; ``x`` s8, or
    with ``scale`` f32 in any strides, quantized as it loads (see the
    module docstring).  CPU tensors run the plain version; CUDA tensors
    launch a kernel or raise."""
    x, w = _operand(x, "x", 4, scale), _operand(w, "w", 4)
    n, h, wd, c = x.shape
    o, kh, kw, cg = w.shape
    groups = int(num_group)
    sh, sw = (int(v) for v in stride)
    ph, pw = (int(v) for v in pad)
    dh, dw = (int(v) for v in dilate)
    if groups <= 0 or c != cg * groups or o % groups:
        raise MXNetError("int8_conv: %d channels and %d filters do not "
                         "split into %d groups of weight %s"
                         % (c, o, groups, tuple(w.shape)))
    p = conv_out_size(h, kh, sh, ph, dh)
    q = conv_out_size(wd, kw, sw, pw, dw)
    if p <= 0 or q <= 0 or min(sh, sw, dh, dw) <= 0 or min(ph, pw) < 0:
        raise MXNetError("int8_conv: input %s, kernel %s, stride %s, pad %s,"
                         " dilate %s give no output"
                         % (tuple(x.shape), (kh, kw), (sh, sw), (ph, pw),
                            (dh, dw)))
    dev = x.device
    if w.device != dev:
        raise MXNetError("int8_conv: operands on %s and %s"
                         % (dev, w.device))
    bias = _check_bias(bias, o, denom, dev)
    if dev.type == "cpu":
        if scale is not None:
            x = quantize_int8(x, scale)
        return int8_conv_ref(x, w, (sh, sw), (ph, pw), (dh, dw), groups,
                             bias, denom)
    if dev.type != "cuda":
        raise MXNetError("int8_conv runs on cuda or cpu tensors, got %s"
                         % dev)
    out = torch.empty(n, p, q, o, device=dev, dtype=torch.int32
                      if denom is None else torch.float32)
    if out.numel() == 0:
        return out
    _conv_launch(int8_conv, "int8_conv", x, w, out, bias,
                 (p, q, sh, sw, ph, pw, dh, dw), groups, denom, scale)
    return out


int8_conv.launches = 0
for _fn in (int8_gemm, int8_conv):
    for _route in ROUTES:
        for _mode in MODES:
            setattr(_fn, "%s_%s" % (_route, _mode), 0)


def route_counts(fn):
    """``{"<route>_<mode>": launches}`` of ``int8_gemm`` or ``int8_conv``."""
    return {"%s_%s" % (r, m): getattr(fn, "%s_%s" % (r, m))
            for r in ROUTES for m in MODES}


def zero_counts():
    """Set every launch count of O5 and O6 to 0."""
    for fn in (int8_gemm, int8_conv):
        fn.launches = 0
        for key in route_counts(fn):
            setattr(fn, key, 0)
