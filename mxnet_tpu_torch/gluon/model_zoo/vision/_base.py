"""What the vision nets share (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/_base.py``): the layout and the
carrying of the JAX package's weights.

A net takes NCHW image batches whatever its layout.  ``layout=None``
resolves through the policy (``layout.preferred_layout``): channels-last
on a CUDA device, NCHW on the host.  A channels-last net changes the
input's memory format once at the stem (``torch.channels_last``) and
views it as NHWC, which costs no second copy; its layers then take and
return NHWC tensors, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from .... import layout as _layout
from ....base import MXNetError
from ....context import resolve
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

    def _build_scope(self):
        """Build child layers under this net's layout."""
        return _layout.layout_scope(self._layout)

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
    last = _ops.channel_last(layout or getattr(net, "_layout", "NCHW"))
    convs = {name + ".weight" if name else "weight"
             for name, m in net.named_modules() if isinstance(m, _Conv)}
    with torch.no_grad():
        for name, t in own.items():
            a = np.array(params[name], dtype=np.float32)
            if name in convs and last:
                nd = a.ndim - 2
                a = a.transpose(nd + 1, nd, *range(nd))     # HWIO -> OIHW
            if isinstance(t, torch.nn.parameter.UninitializedTensorMixin):
                handles[name]._materialize(a.shape)
            if tuple(a.shape) != tuple(t.shape):
                raise MXNetError("load_jax_params: %s has shape %s, the "
                                 "net wants %s" % (name, a.shape,
                                                   tuple(t.shape)))
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            t._initialized = True
    return net
