"""What the vision nets share (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/_base.py``): the layout and the
carrying of the JAX package's weights.

A net takes NCHW image batches whatever its layout.  ``layout=None``
resolves through the policy (``layout.preferred_layout``): channels-last
on a CUDA device, NCHW on the host.  A channels-last net changes the
input's memory format once at the stem (``torch.channels_last``) and
views it as NHWC, which costs no second copy; its layers then take and
return NHWC tensors, as the JAX package's do.  A net's layers are built
under its layout and on its device (``_build_scope``).

A net that flattens a feature map into a ``Dense`` layer (AlexNet, VGG,
DenseNet, Inception-v3) names that layer and the map's channel count in
``_flat_dense``: the layer's columns are in (C, H, W) order in an NCHW
net and in (H, W, C) order in an NHWC one, so ``load_jax_params``
permutes them when the two nets' layouts differ.

``pretrained=True`` loads ``root/<name>.params`` (``load_parameters``)
into a net built NCHW unless ``layout`` says otherwise, as the JAX
package loads the reference's files; no file there raises.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .... import layout as _layout
from ....base import MXNetError
from ....context import Context, resolve
from ....ops import nn as _ops
from ...block import HybridBlock
from ...nn.conv_layers import _Conv


class _LayoutNet(HybridBlock):
    """Base of the vision nets: layout-parametric, with an NCHW input."""

    def __init__(self, layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = resolve(device)
        self._layout = layout if layout is not None \
            else _layout.preferred_layout(2, self._device)
        self._flat_dense = {}   # structural name -> channels flattened

    @contextlib.contextmanager
    def _build_scope(self):
        """Build child layers under this net's layout, on its device."""
        with _layout.layout_scope(self._layout), \
                Context.from_device(self._device):
            yield

    def _stem_input(self, x):
        if _ops.channel_last(self._layout):
            return _ops.to_channel_last(
                x.contiguous(memory_format=torch.channels_last))
        return x


def load_jax_params(net, params, layout=None):
    """Load ``{structural name: numpy array}`` (the JAX package's
    ``net._collect_params_with_prefix()``, running statistics included)
    into ``net``'s parameters and buffers, each in its dtype, memory
    format and device.  A convolution weight is taken as OIHW when the
    JAX net was built channel-first and as HWIO when it was built
    channels-last; ``layout`` is the JAX net's (default: ``net``'s own).
    A tensor whose shape is still deferred gets it from the array.
    Strict: a missing, extra or mis-shaped name raises and names it."""
    handles = net._param_handles()
    own = {k: p._tensor for k, p in handles.items()}
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, unexpected %s"
                         % (missing, extra))
    own_layout = getattr(net, "_layout", "NCHW")
    last = _ops.channel_last(layout or own_layout)
    convs = {name + ".weight" if name else "weight"
             for name, m in net.named_modules() if isinstance(m, _Conv)}
    # a flattened map's columns, where the JAX net's layout is not ours
    flat = {} if last == _ops.channel_last(own_layout) else {
        name + ".weight": c
        for name, c in getattr(net, "_flat_dense", {}).items()}
    with torch.no_grad():
        for name, t in own.items():
            a = np.array(params[name], dtype=np.float32)
            if name in convs and last:
                nd = a.ndim - 2
                a = a.transpose(nd + 1, nd, *range(nd))     # HWIO -> OIHW
            if name in flat:
                a = _permute_columns(a, flat[name], last)
            if isinstance(t, torch.nn.parameter.UninitializedTensorMixin):
                handles[name]._materialize(a.shape)
            if tuple(a.shape) != tuple(t.shape):
                raise MXNetError("load_jax_params: %s has shape %s, the "
                                 "net wants %s" % (name, a.shape,
                                                   tuple(t.shape)))
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            t._initialized = True
    return net


def _permute_columns(w, channels, from_last):
    """A ``Dense`` weight's columns over a flattened (C, H, W) map
    (``from_last`` False) in (H, W, C) order, or back."""
    units, cols = w.shape
    if from_last:
        w = w.reshape(units, cols // channels, channels).transpose(0, 2, 1)
    else:
        w = w.reshape(units, channels, cols // channels).transpose(0, 2, 1)
    return np.ascontiguousarray(w.reshape(units, cols))


def pretrained_kwargs(pretrained, kwargs):
    """``kwargs`` with ``layout`` NCHW by default where ``pretrained``:
    the reference's files hold NCHW (OIHW) weights."""
    if pretrained:
        kwargs.setdefault("layout", "NCHW")
    return kwargs


def load_pretrained(net, root, name):
    """Load ``root/<name>.params`` into ``net``; no file there raises."""
    path = os.path.join(os.path.expanduser(root or os.path.join(
        "~", ".mxnet", "models")), "%s.params" % name)
    if not os.path.isfile(path):
        raise MXNetError("pretrained=True: no weights for %s at %s (the "
                         "port ships none and downloads none)" % (name, path))
    net.load_parameters(path)
    return net
