"""``gluon.contrib`` (the port's counterpart of
``mxnet_tpu/gluon/contrib/``; parity: python/mxnet/gluon/contrib/).

``nn`` and ``rnn`` are here.  The JAX package's other names here,
``estimator``, ``cnn`` and ``data``, come with slice S9 (ROADMAP.md §1):
each raises ``MXNetError`` naming S9 where it is reached.
"""
from ...base import MXNetError
from . import nn, rnn  # noqa: F401

_S9 = ("estimator", "cnn", "data")


def __getattr__(name):
    if name in _S9:
        raise MXNetError("gluon.contrib.%s is not ported yet: it comes with "
                         "slice S9 (ROADMAP.md)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
