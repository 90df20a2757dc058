"""``gluon.contrib.nn`` — auxiliary layers (the port's counterpart of
``mxnet_tpu/gluon/contrib/nn.py``; parity:
gluon/contrib/nn/basic_layers.py).

``SparseEmbedding`` is ``nn.Embedding(..., sparse_grad=True)``: its
weight's gradient is row-sparse and ``gluon.Trainer`` updates the rows it
lists lazily.  ``SyncBatchNorm`` (BatchNorm over the batch of every
device) comes with slice S8, the parallel tier: constructing one raises
``MXNetError``.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock  # noqa: F401  (the JAX package's name)
from .. import nn as _nn


class Concurrent(_nn.HybridConcurrent):
    """Each child on the same input, the outputs concatenated along
    ``axis`` (ref :29)."""


class HybridConcurrent(Concurrent):
    """Alias of Concurrent (ref :77)."""


class Identity(_nn.Identity):
    """Pass-through block (ref :127), for Concurrent branches."""


class SparseEmbedding(_nn.Embedding):
    """Embedding with row-sparse gradients (ref :147): sugar for
    ``nn.Embedding(..., sparse_grad=True)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device BatchNorm (ref :187): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("gluon.contrib.nn.SyncBatchNorm is not ported yet: "
                         "it comes with slice S8, the parallel tier "
                         "(ROADMAP.md)")


def _factors(factor, n):
    try:
        return (int(factor),) * n
    except TypeError:
        out = tuple(int(f) for f in factor)
        assert len(out) == n, "wrong length %s" % (factor,)
        return out


class PixelShuffle1D(HybridBlock):
    """Pixel-shuffle upsampling in 1D: (N, C*f, W) -> (N, C, W*f)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def forward(self, x):
        f = self._factor
        n, cf, w = x.shape
        x = x.reshape(n, cf // f, f, w).permute(0, 1, 3, 2)
        return x.reshape(n, cf // f, w * f)

    def __repr__(self):
        return "PixelShuffle1D(%d)" % self._factor


class PixelShuffle2D(HybridBlock):
    """Pixel-shuffle upsampling in 2D: (N, C*f1*f2, H, W) ->
    (N, C, H*f1, W*f2)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 2)

    def forward(self, x):
        f1, f2 = self._factors
        n, c, h, w = x.shape
        co = c // (f1 * f2)
        x = x.reshape(n, co, f1, f2, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, co, h * f1, w * f2)

    def __repr__(self):
        return "PixelShuffle2D(%s)" % (self._factors,)


class PixelShuffle3D(HybridBlock):
    """Pixel-shuffle upsampling in 3D: (N, C*f1*f2*f3, D, H, W) ->
    (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor):
        super().__init__()
        self._factors = _factors(factor, 3)

    def forward(self, x):
        f1, f2, f3 = self._factors
        n, c, d, h, w = x.shape
        co = c // (f1 * f2 * f3)
        x = x.reshape(n, co, f1, f2, f3, d, h, w).permute(
            0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(n, co, d * f1, h * f2, w * f3)

    def __repr__(self):
        return "PixelShuffle3D(%s)" % (self._factors,)
