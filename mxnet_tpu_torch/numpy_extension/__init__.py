"""``mx.npx``: the NumPy-extension namespace (the port's counterpart of
the JAX package's ``numpy_extension``; reference:
``python/mxnet/numpy_extension`` and ``npx.set_np`` in
``python/mxnet/util.py``).

The operator-style functions (neural-net ops with no NumPy equivalent)
are the registry ops of ``mx.nd``: an op's results take the class of its
first input, so they give ``mx.np.ndarray``s when fed them.

``set_np`` is a switch kept for the API: zero-dim and zero-size shapes
are always legal in the port, so the flags only record what the user
asked for (``is_np_shape``/``is_np_array`` report it).  The flags are
per thread.  ``rnn`` is the ``RNN`` op (cuDNN's fused recurrence on
the card).
"""
from __future__ import annotations

import functools
import threading

from .. import ndarray as _nd

_flags = threading.local()


def _st():
    if not hasattr(_flags, "np_shape"):
        _flags.np_shape = False
        _flags.np_array = False
    return _flags


def set_np(shape=True, array=True):
    """Turn NumPy semantics on (parity: util.py set_np)."""
    if array and not shape:
        raise ValueError("np_array requires np_shape")
    st = _st()
    st.np_shape, st.np_array = shape, array


def reset_np():
    set_np(False, False)


def is_np_shape():
    return _st().np_shape


def is_np_array():
    return _st().np_array


def set_np_shape(active):
    """Set the np-shape flag; returns the previous one."""
    st = _st()
    prev, st.np_shape = st.np_shape, bool(active)
    return prev


class np_shape:
    """Scope forcing the np-shape flag (parity: util.np_shape)."""

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = set_np_shape(self._active)
        return self

    def __exit__(self, *a):
        set_np_shape(self._prev)


class np_array:
    """Scope forcing the np-array flag (parity: util.np_array)."""

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = st.np_array
        st.np_array = bool(self._active)
        return self

    def __exit__(self, *a):
        _st().np_array = self._prev


def use_np(func):
    """Decorator running ``func`` under NumPy semantics (parity:
    util.use_np)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        st = _st()
        prev = (st.np_shape, st.np_array)
        st.np_shape = st.np_array = True
        try:
            return func(*args, **kwargs)
        finally:
            st.np_shape, st.np_array = prev

    return wrapper


# -- the operator namespace: registry ops, which keep mx.np's class ---------
activation = _nd.Activation
batch_norm = _nd.BatchNorm
convolution = _nd.Convolution
deconvolution = _nd.Deconvolution
fully_connected = _nd.FullyConnected
pooling = _nd.Pooling
dropout = _nd.Dropout
rnn = _nd.RNN
embedding = _nd.Embedding
layer_norm = _nd.LayerNorm
group_norm = _nd.GroupNorm
instance_norm = _nd.InstanceNorm
l2_normalization = _nd.L2Normalization
leaky_relu = _nd.LeakyReLU
softmax = _nd.softmax
log_softmax = _nd.log_softmax
sequence_mask = _nd.SequenceMask
topk = _nd.topk
pick = _nd.pick
one_hot = _nd.one_hot
gather_nd = _nd.gather_nd
scatter_nd = _nd.scatter_nd
reshape_like = _nd.reshape_like
arange_like = _nd.contrib.arange_like
batch_dot = _nd.batch_dot
smooth_l1 = _nd.smooth_l1
sigmoid = _nd.sigmoid
relu = _nd.relu
erf = _nd.erf
erfinv = _nd.erfinv
gamma = _nd.gamma
gammaln = _nd.gammaln
cumsum = _nd.cumsum
foreach = _nd.contrib.foreach
while_loop = _nd.contrib.while_loop
cond = _nd.contrib.cond


def seed(s):
    from .. import random as _random

    _random.seed(s)


def waitall():
    _nd.waitall()
