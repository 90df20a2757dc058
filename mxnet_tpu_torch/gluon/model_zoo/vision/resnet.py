"""ResNet v1 and v2 (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

The blocks and nets are the JAX package's, attribute for attribute
(``features``, ``output``, ``body``, ``downsample``, ``bn1``, ...) and
name scope for name scope, so both ``collect_params()`` (the prefixed
names, ``resnetv10_stage1_conv0_weight``) and
``_collect_params_with_prefix()`` (the structural ones) name what the
JAX package's do.  Every block takes ``device=`` (default ``cuda:0``).  No
pretrained weights are shipped: ``pretrained=True`` loads
``root/resnet<layers>_v<version>.params`` from a local directory into an
NCHW net, and raises where there is no such file.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn
from ._base import _LayoutNet, load_pretrained, pretrained_kwargs


def _conv3x3(channels, stride, in_channels, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


def _downsample(channels, stride, in_channels, device):
    ds = nn.HybridSequential(prefix="")
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                     use_bias=False, in_channels=in_channels, device=device))
    ds.add(nn.BatchNorm(device=device))
    return ds


class BasicBlockV1(HybridBlock):
    """ResNet-v1 basic block: conv-bn-relu x2 + residual."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, device))
        self.body.add(nn.BatchNorm(device=device))
        self.downsample = _downsample(channels, stride, in_channels,
                                      device) if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(residual + x)


class BottleneckV1(HybridBlock):
    """ResNet-v1 bottleneck: 1x1 - 3x3 - 1x1 + residual (the 1x1 convs
    carry a bias, as in the reference)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                device=device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, device))
        self.body.add(nn.BatchNorm(device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                device=device))
        self.body.add(nn.BatchNorm(device=device))
        self.downsample = _downsample(channels, stride, in_channels,
                                      device) if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BasicBlockV2(HybridBlock):
    """ResNet-v2 basic block: pre-activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(channels, 1, channels, device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """ResNet-v2 bottleneck: pre-activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm(device=device)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, device=device)
        self.bn2 = nn.BatchNorm(device=device)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, device)
        self.bn3 = nn.BatchNorm(device=device)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, device=device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        x = self.conv3(x)
        return x + residual


class _ResNet(_LayoutNet):
    """What ResNetV1 and ResNetV2 share: the stages and the forward."""

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, device=self._device,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                device=self._device, prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(self._stem_input(x)))


class ResNetV1(_ResNet):
    """ResNet v1 (parity: resnet.py ResNetV1)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1: %d stages need %d channel counts, "
                             "got %d" % (len(layers), len(layers) + 1,
                                         len(channels)))
        dev = self._device
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, dev))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, device=dev))
                self.features.add(nn.BatchNorm(device=dev))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1],
                                   device=dev)


class ResNetV2(_ResNet):
    """ResNet v2 (parity: resnet.py ResNetV2)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None, **kwargs):
        super().__init__(layout=layout, device=device, **kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2: %d stages need %d channel counts, "
                             "got %d" % (len(layers), len(layers) + 1,
                                         len(channels)))
        dev = self._device
        with self._build_scope(), self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           device=dev))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, dev))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, device=dev))
                self.features.add(nn.BatchNorm(device=dev))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(device=dev))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels,
                                   device=dev)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """A ResNet by version (1, 2) and depth (18, 34, 50, 101, 152);
    ``kwargs`` go to the net (``classes``, ``thumbnail``, ``layout``,
    ``device``).  ``ctx`` is taken as ``device``; ``pretrained`` loads
    ``root``'s ``.params`` file (``_base.load_pretrained``)."""
    if num_layers not in resnet_spec:
        raise MXNetError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise MXNetError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    block_type, layers, channels = resnet_spec[num_layers]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_net_versions[version - 1](
        block_class, layers, channels, **pretrained_kwargs(pretrained,
                                                           kwargs))
    if pretrained:
        load_pretrained(net, root, "resnet%d_v%d" % (num_layers, version))
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
