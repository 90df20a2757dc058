"""DenseNet 121/161/169/201 (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``): the JAX package's
layers, names and order.  Each dense layer concatenates its output to
its input on the channel axis, channels-last on the card (the NHWC
tensors stay contiguous: no copy but the concat's own)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ...nn.basic_layers import _concat
from .... import layout as _layout
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index):
    out = nn.HybridSequential(prefix="stage%d_" % stage_index)
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


class _DenseLayer(HybridBlock):
    """BN-ReLU-1x1 conv, BN-ReLU-3x3 conv, concatenated with the
    input."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self._caxis = _layout.current_channel_axis()
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return _concat([x, self.body(x)], self._caxis)


def _make_transition(num_output_features):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(_LayoutNet):
    """DenseNet (parity: densenet.DenseNet)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, layout=None,
                 device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features = num_features // 2
                    self.features.add(_make_transition(num_features))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)
            self._flat_dense["output"] = num_features

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


# num_init_features, growth_rate, block_config
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                 **kwargs):
    """DenseNet of ``num_layers`` (121, 161, 169, 201); ``ctx`` is taken
    as ``device``."""
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    net = DenseNet(num_init_features, growth_rate, block_config,
                   **pretrained_kwargs(pretrained, kwargs))
    if pretrained:
        load_pretrained(net, root, "densenet%d" % num_layers)
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
