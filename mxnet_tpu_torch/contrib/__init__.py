"""``mx.contrib`` — contrib namespaces (the port's counterpart of
``mxnet_tpu/contrib/__init__.py``; parity: python/mxnet/contrib/).

``amp`` (the port's ``mx.amp``, at the reference path ``mx.contrib.amp``)
and ``quantization`` are here.  The other names the JAX package has here
are modules of slice S9 (ROADMAP.md §1): ``onnx``, ``text``,
``tensorboard``, ``svrg_optimization``, ``io``, ``autograd``,
``DataLoaderIter`` and ``TrainingStateScope``.  Each raises
``MXNetError`` naming S9 where it is reached.
"""
from .. import amp  # noqa: F401  (reference path mx.contrib.amp)
from ..base import MXNetError
from . import quantization  # noqa: F401

_S9 = ("onnx", "text", "tensorboard", "svrg_optimization", "io", "autograd",
       "DataLoaderIter", "TrainingStateScope")


def __getattr__(name):
    if name in _S9:
        raise MXNetError("mx.contrib.%s is not ported yet: it comes with "
                         "slice S9 (ROADMAP.md)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
