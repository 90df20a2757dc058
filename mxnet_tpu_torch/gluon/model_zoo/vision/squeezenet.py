"""SqueezeNet 1.0 and 1.1 (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``): the JAX package's
layers, names and order.  Its max pooling rounds up (``ceil_mode``, the
"full" convention); the fire modules concatenate on the channel axis."""
from __future__ import annotations

from ... import nn
from .... import layout as _layout
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = nn.HybridConcurrent(axis=_layout.current_channel_axis(),
                                prefix="")
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class SqueezeNet(_LayoutNet):
    """SqueezeNet (parity: squeezenet.SqueezeNet)."""

    def __init__(self, version, classes=1000, layout=None, device=None,
                 **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        assert version in ("1.0", "1.1"), \
            "Unsupported SqueezeNet version %s: 1.0 or 1.1 expected" % version
        if version == "1.0":
            stem = (96, 7)
            fires = ((16, 64), (16, 64), (32, 128), "pool", (32, 128),
                     (48, 192), (48, 192), (64, 256), "pool", (64, 256))
        else:
            stem = (64, 3)
            fires = ((16, 64), (16, 64), "pool", (32, 128), (32, 128),
                     "pool", (48, 192), (48, 192), (64, 256), (64, 256))
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem[0], kernel_size=stem[1],
                                        strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            for fire in fires:
                if fire == "pool":
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                                   ceil_mode=True))
                else:
                    self.features.add(_make_fire(fire[0], fire[1], fire[1]))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    """SqueezeNet ``version`` ("1.0" or "1.1"); ``ctx`` is taken as
    ``device``."""
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = SqueezeNet(version, **pretrained_kwargs(pretrained, kwargs))
    if pretrained:
        load_pretrained(net, root, "squeezenet%s" % version)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
