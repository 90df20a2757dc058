"""O5 ``int8_gemm`` and O6 ``int8_conv``: the port-only int8 x int8 ->
int32 products behind the quantized ops and layers.

No Pallas kernel stands behind them.  The JAX package hands its int8
contractions to XLA with ``preferred_element_type=int32`` (the MXU's int8
mode): ``mxnet_tpu/ops/quantized_ops.py``'s ``_quantized_fc`` and
``_quantized_conv``, and ``mxnet_tpu/contrib/quantization.py``'s
``QuantizedDense`` and ``QuantizedConv2D``.  Torch has no int8
convolution on CUDA, so both are CUDA C++ in ``csrc/int8_ops.cu`` (built
by ``ops/_build.py`` at first use), one kernel for both: O5 is O6 at
1 x 1 x 1 x 1.

- ``int8_gemm(a, b)``: ``a`` (M, K) s8, ``b`` (N, K) s8 (both
  K-contiguous, as ``dot_general`` contracts ``(ndim-1, 1)``) give (M, N).
- ``int8_conv(x, w, ...)``: ``x`` (N, H, W, C) s8 channels-last, ``w``
  (O, KH, KW, C / groups) s8 (OHWI) give (N, P, Q, O), with stride, zero
  padding, dilation and groups.

Each takes one of two epilogues: ``denom=None`` gives the s32 sums plus
an s32 ``bias`` (the registered ops' accumulator and rounded bias), a
float ``denom`` gives f32 ``f32(acc) / denom + bias`` with an f32
``bias`` (the layers' dequantize), each operation rounded once.  Sums are
exact and the epilogue is correctly rounded, so the kernels equal their
plain versions (``int8_gemm_ref``, ``int8_conv_ref``: the product or
convolution in float64 of the int8 values, exact below 2**53) bit for
bit.  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises: nothing falls back.  Launches go on the current
stream, so a captured graph replays them; ``int8_gemm.launches`` and
``int8_conv.launches`` count them (``graph_cache.count``, replays
included).

``quantize_int8(x, scale)`` is the activation quantize the layers put in
front of the kernels, ``clip(round(x * f32(scale)), -127, 127)`` as int8
(round half to even), in plain torch elementwise ops, as the JAX package
leaves it to XLA outside any kernel.
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


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the four pointers, the 16 shape ints and the epilogue, denom, stream
    lib.mxtt_int8_conv.argtypes = [p] * 4 + [i] * 17 + [f, p]
    lib.mxtt_int8_conv.restype = i
    lib.mxtt_int8_gemm.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.mxtt_int8_gemm.restype = i
    lib.mxtt_int8_error_string.argtypes = [i]
    lib.mxtt_int8_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def quantize_int8(x, scale):
    """``clip(round(x * f32(scale)), -127, 127)`` as int8: the product in
    f32 (a number ``scale`` rounded to f32 first, a tensor as it is),
    rounded half to even."""
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


def _operand(t, what, dim):
    if t.dtype != torch.int8 or t.dim() != dim:
        raise MXNetError("int8 kernels: %s must be a %d-d int8 tensor, got "
                         "%s %s" % (what, dim, tuple(t.shape), t.dtype))
    return t.contiguous()


def _raise(lib, err, what):
    if err != 0:
        raise MXNetError("%s kernel launch failed: %d (%s)"
                         % (what, err, lib.mxtt_int8_error_string(err)
                            .decode()))


def int8_gemm(a, b, bias=None, denom=None):
    """O5: ``a`` (M, K) s8 times ``b`` (N, K) s8 over K (see the module
    docstring for the two epilogues).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    a, b = _operand(a, "a", 2), _operand(b, "b", 2)
    if a.shape[1] != b.shape[1]:
        raise MXNetError("int8_gemm: K differs: %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    dev = a.device
    if b.device != dev:
        raise MXNetError("int8_gemm: operands on %s and %s"
                         % (dev, b.device))
    bias = _check_bias(bias, b.shape[0], denom, dev)
    if dev.type == "cpu":
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
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.mxtt_int8_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(), m, n, k,
            _EPI_S32 if denom is None else _EPI_F32,
            0.0 if denom is None else float(denom),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, err, "int8_gemm")
    _graph_cache.count(int8_gemm, "launches")
    return out


int8_gemm.launches = 0


def int8_conv(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_group=1,
              bias=None, denom=None):
    """O6: ``x`` (N, H, W, C) s8 convolved by ``w`` (O, KH, KW, C /
    ``num_group``) s8 into (N, P, Q, O), channels last (see the module
    docstring for the two epilogues).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    x, w = _operand(x, "x", 4), _operand(w, "w", 4)
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
        return int8_conv_ref(x, w, (sh, sw), (ph, pw), (dh, dw), groups,
                             bias, denom)
    if dev.type != "cuda":
        raise MXNetError("int8_conv runs on cuda or cpu tensors, got %s"
                         % dev)
    out = torch.empty(n, p, q, o, device=dev, dtype=torch.int32
                      if denom is None else torch.float32)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.mxtt_int8_conv(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(), n, h, wd, c, o, kh,
            kw, p, q, sh, sw, ph, pw, dh, dw, groups,
            _EPI_S32 if denom is None else _EPI_F32,
            0.0 if denom is None else float(denom),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, err, "int8_conv")
    _graph_cache.count(int8_conv, "launches")
    return out


int8_conv.launches = 0
