"""AlexNet (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``): the JAX package's
layers, names and order.  The features end in ``Flatten`` and two
``Dense`` layers; the first one's columns follow the net's layout
(``_base``)."""
from __future__ import annotations

from ... import nn
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


class AlexNet(_LayoutNet):
    """AlexNet (parity: alexnet.AlexNet)."""

    def __init__(self, classes=1000, layout=None, device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self._flat_dense["features.%d" % (len(self.features) - 1)] \
                    = 256
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """AlexNet; ``ctx`` is taken as ``device``."""
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = AlexNet(**pretrained_kwargs(pretrained, kwargs))
    return load_pretrained(net, root, "alexnet") if pretrained else net
