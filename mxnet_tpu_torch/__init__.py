"""mxnet_tpu_torch: the PyTorch + CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package mirrors its paths and
public names and imports neither JAX nor anything of ``mxnet_tpu``.
Ported so far: the Llama serving tier (``serve``) with the paged
attention kernel (``ops.paged_attention``), Llama training (``gluon``,
``initializer``, ``optimizer``, ``parallel.JitTrainStep``) with the
flash-attention forward and backward kernels (``ops.flash_attention``),
all kernels CUDA C++ for sm_90a in ``csrc/``, and the telemetry and
testing modules the serving tier uses.

Entry points run on ``cuda:0`` unless given ``device="cpu"``.
"""
from . import base, context, ops, serve, telemetry, testing  # noqa: F401
from . import gluon, initializer, optimizer, parallel  # noqa: F401
from . import initializer as init  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import cpu, gpu  # noqa: F401

__version__ = "0.1.0"
