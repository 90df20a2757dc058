"""VGG 11/13/16/19, with and without BatchNorm (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``): the JAX package's layers,
initializers, names and order.  The first ``Dense`` layer's columns
follow the net's layout (``_base``)."""
from __future__ import annotations

from ... import nn
from .... import initializer as init
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


class VGG(_LayoutNet):
    """VGG (parity: vgg.VGG)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 layout=None, device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        assert len(layers) == len(filters)
        with self._build_scope(), self.name_scope():
            self.features = self._make_features(layers, filters,
                                                batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self._flat_dense["features.%d" % (len(self.features) - 1)] \
                = filters[-1]
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(
                    filters[i], kernel_size=3, padding=1,
                    weight_initializer=init.Xavier(
                        rnd_type="gaussian", factor_type="out",
                        magnitude=2)))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """VGG of ``num_layers`` (11, 13, 16, 19); ``batch_norm=True`` adds
    BatchNorm after each convolution; ``ctx`` is taken as ``device``."""
    layers, filters = vgg_spec[num_layers]
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = VGG(layers, filters, **pretrained_kwargs(pretrained, kwargs))
    if pretrained:
        load_pretrained(net, root, "vgg%d%s" % (
            num_layers, "_bn" if kwargs.get("batch_norm") else ""))
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
