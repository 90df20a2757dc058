"""Convolution and pooling layers (the port's counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).

The MXNet arguments and defaults are the JAX package's; each layer calls
the op of ``ops/nn.py`` the JAX package's layer calls.  A layer built
with no ``layout=`` takes the policy's (``layout.default_layout``:
channel-first unless a channels-last scope or policy says otherwise).

The weight is OIHW (``(channels, in_channels / groups) + kernel``) in
every layout; a channels-last layer keeps it in ``torch.channels_last``
memory (``channels_last_3d`` for 3-d kernels) and hands the op its HWIO
view, which is what the JAX package stores (``load_jax_params`` of the
vision zoo takes either).  With ``in_channels=0`` the weight's shape is
taken from the first input and the weight is filled then, with the
initializer ``initialize`` was given, as ``nn.Dense`` does.  Every
layer takes ``device=`` (default ``cuda:0``).

The transposed convolutions (``Conv1DTranspose``, ``Conv2DTranspose``,
``Conv3DTranspose``) run the ``Deconvolution`` op with their
``output_padding`` as its ``adj``; their weight is (in_channels,
channels / groups) + kernel, the JAX package's and the ``.params``
file's layout, deferred while ``in_channels=0``.  Their layout defaults
to the channel-first one, whatever the policy, as in the JAX package;
an explicit channels-last layout raises ``ValueError`` at the first
forward, as the JAX package's op does.  ``ReflectionPad2D`` is the
``pad`` op in ``reflect`` mode.
"""
from __future__ import annotations

import weakref

import torch

from ... import layout as _layout
from ...base import MXNetError
from ...context import resolve
from ...ops import nn as _ops
from ...ops import tensor as _tensor_ops
from ..block import HybridBlock
from .activations import Activation

_LAZY = torch.nn.parameter.UninitializedParameter


def _pair(x, n):
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,) * n


def memory_format(layout, ndim):
    """The torch memory format a weight of a layer in ``layout`` with
    ``ndim`` spatial dims is kept in (None: the default)."""
    if not _ops.channel_last(layout):
        return None
    return {2: torch.channels_last, 3: torch.channels_last_3d}.get(ndim)


class _Conv(HybridBlock):
    """What the convolution layers share (parity: conv_layers.py
    _Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        nd = len(kernel_size)
        if layout is None:
            layout = _layout.default_layout(nd)
        dev = resolve(device)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": tuple(kernel_size), "stride": _pair(strides, nd),
            "dilate": _pair(dilation, nd), "pad": _pair(padding, nd),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._layout = layout
        self._groups = groups
        self._nd = nd
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True,
                device=dev)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True, device=dev) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None
        weight = self._reg_params["weight"]
        weight._on_materialize = weakref.WeakMethod(self._set_format)
        if _ops.channel_last(layout):
            weight._file_layout = "hwio"
        if in_channels > 0:
            self._set_format()

    def _weight_shape(self, in_channels):
        return (self._channels, in_channels // self._groups) \
            + self._kwargs["kernel"]

    def _set_format(self):
        fmt = memory_format(self._layout, self._nd)
        if fmt is not None:
            self.weight.data = self.weight.data.contiguous(memory_format=fmt)

    def _shape_hint(self, x, *args):
        p = self._reg_params["weight"]
        if p.shape and p.shape[1] == 0:
            self._in_channels = x.shape[_layout.channel_axis(self._layout)]
            p.shape = self._weight_shape(self._in_channels)

    def forward(self, x):
        if isinstance(self.weight, _LAZY):
            self._in_channels = x.shape[_layout.channel_axis(self._layout)]
            self._finish_param("weight",
                               self._weight_shape(self._in_channels))
        w = self.weight
        if _ops.channel_last(self._layout):
            w = w.permute(*range(2, self._nd + 2), 1, 0)     # HWIO view
        out = _ops._convolution(x, w, self.bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return "%s(%s, kernel_size=%s, stride=%s, layout=%s)" % (
            type(self).__name__, self._channels, self._kwargs["kernel"],
            self._kwargs["stride"], self._layout)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout=None,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout=None, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """What the transposed convolution layers share: the ``Deconvolution``
    op with ``adj``, weight (in_channels, channels / groups) + kernel."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)
        self._kwargs["adj"] = _pair(output_padding, len(kernel_size))

    def _weight_shape(self, in_channels):
        return (in_channels, self._channels // self._groups) \
            + self._kwargs["kernel"]

    def _shape_hint(self, x, *args):
        p = self._reg_params["weight"]
        if p.shape and p.shape[0] == 0:
            self._in_channels = x.shape[_layout.channel_axis(self._layout)]
            p.shape = self._weight_shape(self._in_channels)

    def forward(self, x):
        if isinstance(self.weight, _LAZY):
            self._in_channels = x.shape[_layout.channel_axis(self._layout)]
            self._finish_param("weight",
                               self._weight_shape(self._in_channels))
        out = _ops._deconvolution(x, self.weight, self.bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,)
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 3
        super().__init__(channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """What the pooling layers share (parity: conv_layers.py _Pooling)."""

    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=None, ceil_mode=False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        nd = len(pool_size)
        if layout is None:
            layout = _layout.default_layout(nd)
        self._kwargs = {
            "kernel": tuple(pool_size), "stride": _pair(strides, nd),
            "pad": _pair(padding, nd), "global_pool": global_pool,
            "pool_type": pool_type, "layout": layout,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return _ops._pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                 ceil_mode=False, count_include_pad=True, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,)
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout=None, ceil_mode=False, count_include_pad=True,
                 **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 3
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1,), None, 0, True, "max", layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1), None, 0, True, "max", layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1, 1), None, 0, True, "max", layout, **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1,), None, 0, True, "avg", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1), None, 0, True, "avg", layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1, 1), None, 0, True, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Parity: nn.ReflectionPad2D: an int pads the last two axes by that
    much on each side; else an 8-tuple of (before, after) per axis."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise MXNetError("padding must be int or length-8 tuple")
        self._padding = tuple(padding)

    def forward(self, x):
        return _tensor_ops._pad(x, mode="reflect", pad_width=self._padding)
