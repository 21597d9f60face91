"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

The same blocks, stages and layers in the same order: each module assigns
its children in the order the Gluon block builds them, so ``state_dict()``
(parameters and BatchNorm buffers) lists the arrays in the order of the
JAX model's ``collect_params()``, and ``convert.load_mxnet_params`` pairs
them by position.  Gluon infers each layer's input channels from the first
batch; here the constructors work them out, and the first layer takes
three (RGB images, as every model of the zoo).

Built on ``device`` (default ``cuda:0``; ``device="cpu"`` on request),
uninitialized until ``initializer.initialize`` or
``convert.load_mxnet_params`` fills it.  ``layout="NHWC"`` (or building
inside ``nn.channels_last()``) gives the channel-last model, which takes
(N, H, W, C) images.
"""
from __future__ import annotations

import torch

from ....context import resolve_device
from ...block import Block
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ...nn.conv_layers import _resolve_layout

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, layout, device):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout,
                  device=device)


def _bn(channels, layout, device, **kwargs):
    return BatchNorm(axis=layout.index("C"), in_channels=channels,
                     device=device, **kwargs)


class BasicBlockV1(Block):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None):
        super().__init__()
        layout = _resolve_layout(layout, 2)
        self.body = HybridSequential(
            _conv3x3(channels, stride, in_channels, layout, device),
            _bn(channels, layout, device),
            Activation("relu"),
            _conv3x3(channels, 1, channels, layout, device),
            _bn(channels, layout, device))
        self.downsample = HybridSequential(
            Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                   in_channels=in_channels, layout=layout, device=device),
            _bn(channels, layout, device)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.body(x))


class BottleneckV1(Block):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None):
        super().__init__()
        layout = _resolve_layout(layout, 2)
        mid = channels // 4
        # the 1x1 convs keep Conv2D's bias, as the JAX block's do
        self.body = HybridSequential(
            Conv2D(mid, kernel_size=1, strides=stride,
                   in_channels=in_channels, layout=layout, device=device),
            _bn(mid, layout, device),
            Activation("relu"),
            _conv3x3(mid, 1, mid, layout, device),
            _bn(mid, layout, device),
            Activation("relu"),
            Conv2D(channels, kernel_size=1, strides=1, in_channels=mid,
                   layout=layout, device=device),
            _bn(channels, layout, device))
        self.downsample = HybridSequential(
            Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                   in_channels=in_channels, layout=layout, device=device),
            _bn(channels, layout, device)) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.body(x))


class BasicBlockV2(Block):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None):
        super().__init__()
        layout = _resolve_layout(layout, 2)
        self.bn1 = _bn(in_channels, layout, device)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, device)
        self.bn2 = _bn(channels, layout, device)
        self.conv2 = _conv3x3(channels, 1, channels, layout, device)
        self.downsample = Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout, device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        return self.conv2(x) + residual


class BottleneckV2(Block):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None):
        super().__init__()
        layout = _resolve_layout(layout, 2)
        mid = channels // 4
        self.bn1 = _bn(in_channels, layout, device)
        self.conv1 = Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                            in_channels=in_channels, layout=layout,
                            device=device)
        self.bn2 = _bn(mid, layout, device)
        self.conv2 = _conv3x3(mid, stride, mid, layout, device)
        self.bn3 = _bn(mid, layout, device)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, in_channels=mid, layout=layout,
                            device=device)
        self.downsample = Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout, device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, in_channels, layout,
                device):
    layer = HybridSequential(block(channels, stride, channels != in_channels,
                                   in_channels=in_channels, layout=layout,
                                   device=device))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout, device=device))
    return layer


class ResNetV1(Block):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("layers %r needs %d channels, got %r"
                             % (layers, len(layers) + 1, channels))
        layout = _resolve_layout(layout, 2)
        device = resolve_device(device)
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS,
                                       layout, device))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False,
                       in_channels=_IMAGE_CHANNELS, layout=layout,
                       device=device),
                _bn(channels[0], layout, device),
                Activation("relu"),
                MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, channels[i],
                                          layout, device))
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, channels[-1], device=device)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(Block):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("layers %r needs %d channels, got %r"
                             % (layers, len(layers) + 1, channels))
        layout = _resolve_layout(layout, 2)
        device = resolve_device(device)
        self.features = HybridSequential(
            _bn(_IMAGE_CHANNELS, layout, device, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS,
                                       layout, device))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False,
                       in_channels=_IMAGE_CHANNELS, layout=layout,
                       device=device),
                _bn(channels[0], layout, device),
                Activation("relu"),
                MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          1 if i == 0 else 2, in_channels,
                                          layout, device))
            in_channels = channels[i + 1]
        self.features.add(_bn(in_channels, layout, device),
                          Activation("relu"),
                          GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, in_channels, device=device)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` layers; ``kwargs`` go
    to :class:`ResNetV1`/:class:`ResNetV2` (``classes``, ``thumbnail``,
    ``layout``, ``device``)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, str(resnet_spec.keys())))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not ported: .params files wait for the "
            "port of ndarray serialization; carry a JAX model's weights "
            "across with convert.load_mxnet_params")
    block_type, layers, channels = resnet_spec[num_layers]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block_class, layers, channels,
                                            **kwargs)


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
