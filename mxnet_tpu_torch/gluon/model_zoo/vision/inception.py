"""Inception-v3 (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``): the JAX package's
layers, names and order.  Its mixed blocks are ``HybridConcurrent``s on
the channel axis (channels-last on the card), its pooling branches an
``AvgPool2D`` with padding (the pad counted, as in the JAX package) or a
``MaxPool2D``."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ...nn.basic_layers import _concat
from .... import layout as _layout
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    names = ("channels", "kernel_size", "strides", "padding")
    for setting in conv_settings:
        out.add(_make_basic_conv(**{names[i]: v for i, v in
                                    enumerate(setting) if v is not None}))
    return out


def _concurrent(prefix):
    return nn.HybridConcurrent(axis=_layout.current_channel_axis(),
                               prefix=prefix)


def _make_A(pool_features, prefix):
    out = _concurrent(prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _concurrent(prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    out = _concurrent(prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (c, 1, None, None),
                             (c, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (c, 1, None, None),
                             (c, (7, 1), None, (3, 0)),
                             (c, (1, 7), None, (0, 3)),
                             (c, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _concurrent(prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _SplitConcat(HybridBlock):
    """Two convolutions over one input, concatenated (the E blocks'
    tails)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._caxis = _layout.current_channel_axis()

    def forward(self, x):
        return _concat([b(x) for b in self._modules.values()], self._caxis)


def _split(width, prefix_convs):
    out = nn.HybridSequential(prefix="")
    out.add(_make_branch(None, *prefix_convs))
    split = _SplitConcat()
    split.register_child(_make_branch(None, (width, (1, 3), None, (0, 1))),
                         "a")
    split.register_child(_make_branch(None, (width, (3, 1), None, (1, 0))),
                         "b")
    out.add(split)
    return out


def _make_E(prefix):
    out = _concurrent(prefix)
    with out.name_scope():
        out.add(_make_branch(None, (320, 1, None, None)))
        out.add(_split(384, ((384, 1, None, None),)))
        out.add(_split(384, ((448, 1, None, None), (384, 3, None, 1))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(_LayoutNet):
    """Inception-v3 (parity: inception.Inception3); 299 x 299 inputs."""

    def __init__(self, classes=1000, layout=None, device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            f = self.features
            f.add(_make_basic_conv(channels=32, kernel_size=3, strides=2))
            f.add(_make_basic_conv(channels=32, kernel_size=3))
            f.add(_make_basic_conv(channels=64, kernel_size=3, padding=1))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(_make_basic_conv(channels=80, kernel_size=1))
            f.add(_make_basic_conv(channels=192, kernel_size=3))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(_make_A(32, "A1_"))
            f.add(_make_A(64, "A2_"))
            f.add(_make_A(64, "A3_"))
            f.add(_make_B("B_"))
            f.add(_make_C(128, "C1_"))
            f.add(_make_C(160, "C2_"))
            f.add(_make_C(160, "C3_"))
            f.add(_make_C(192, "C4_"))
            f.add(_make_D("D_"))
            f.add(_make_E("E1_"))
            f.add(_make_E("E2_"))
            f.add(nn.AvgPool2D(pool_size=8))
            f.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
            self._flat_dense["output"] = 2048

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Inception-v3; ``ctx`` is taken as ``device``."""
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = Inception3(**pretrained_kwargs(pretrained, kwargs))
    return load_pretrained(net, root, "inceptionv3") if pretrained else net
