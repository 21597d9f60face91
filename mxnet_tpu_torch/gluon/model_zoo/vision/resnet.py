"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

Built as the JAX package builds them: the same blocks, stages, layers,
name scopes and prefixes (``resnetv10_stage1_conv2d0_weight``), with
``in_channels`` given exactly where the JAX constructors give it, so the
same layers wait for the first batch for their shapes.  The order in which
the weights draw their keys, at ``initialize`` for the known shapes and
then at the first call in forward order for the rest, is therefore the
JAX package's, and ``mx.random.seed(n)`` gives the JAX model's weights.

``device`` (default ``cuda:0``; ``device="cpu"`` on request) is where the
tensors are made; ``layout="NHWC"`` (or building inside
``nn.channels_last()``) gives the channel-last model, which takes (N, H,
W, C) images.  ``pretrained=<path>`` loads a local ``.params`` file
(``model_store.load_pretrained``); ``pretrained=True`` raises, as in the
JAX package: nothing is downloaded.

Each block traces into ``sym.*`` as the JAX block does (``hybrid_forward``),
so ``export`` writes its graph.
"""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ...nn.conv_layers import _resolve_layout

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels, layout=None, device=None):
    layout = _resolve_layout(layout, 2)
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout,
                  device=device)


def _bn_axis(layout):
    return layout.index("C")


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        self.body = HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout, device))
        self.body.add(BatchNorm(axis=ax, device=device))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, device))
        self.body.add(BatchNorm(axis=ax, device=device))
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1, strides=stride,
                                       use_bias=False, in_channels=in_channels,
                                       layout=layout, device=device))
            self.downsample.add(BatchNorm(axis=ax, device=device))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(residual + out)

    def hybrid_forward(self, F, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + out, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        # the 1x1 convs keep Conv2D's bias, as the JAX block's do
        self.body = HybridSequential(prefix="")
        self.body.add(Conv2D(channels // 4, kernel_size=1, strides=stride,
                             layout=layout, device=device))
        self.body.add(BatchNorm(axis=ax, device=device))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout,
                               device))
        self.body.add(BatchNorm(axis=ax, device=device))
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1,
                             layout=layout, device=device))
        self.body.add(BatchNorm(axis=ax, device=device))
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1, strides=stride,
                                       use_bias=False, in_channels=in_channels,
                                       layout=layout, device=device))
            self.downsample.add(BatchNorm(axis=ax, device=device))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(residual + out)

    def hybrid_forward(self, F, x):
        residual = x
        out = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(residual + out, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        self.bn1 = BatchNorm(axis=ax, device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, device)
        self.bn2 = BatchNorm(axis=ax, device=device)
        self.conv2 = _conv3x3(channels, 1, channels, layout, device)
        if downsample:
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, layout=layout,
                                     device=device)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        return self.conv2(x) + residual

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        self.bn1 = BatchNorm(axis=ax, device=device)
        self.conv1 = Conv2D(channels // 4, kernel_size=1, strides=1,
                            use_bias=False, layout=layout, device=device)
        self.bn2 = BatchNorm(axis=ax, device=device)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout,
                              device)
        self.bn3 = BatchNorm(axis=ax, device=device)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, layout=layout, device=device)
        if downsample:
            self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, layout=layout,
                                     device=device)
        else:
            self.downsample = None

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

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels,
                layout, device):
    layer = HybridSequential(prefix="stage%d_" % stage_index)
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout,
                        device=device, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, device=device, prefix=""))
    return layer


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("layers %r needs %d channels, got %r"
                             % (layers, len(layers) + 1, channels))
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout, device))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                         layout=layout, device=device))
                self.features.add(BatchNorm(axis=ax, device=device))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, channels[i], layout, device))
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=channels[-1], device=device)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout=None, device=None, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("layers %r needs %d channels, got %r"
                             % (layers, len(layers) + 1, channels))
        layout = _resolve_layout(layout, 2)
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(BatchNorm(axis=ax, scale=False, center=False,
                                        device=device))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout, device))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                         layout=layout, device=device))
                self.features.add(BatchNorm(axis=ax, device=device))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels, layout, device))
                in_channels = channels[i + 1]
            self.features.add(BatchNorm(axis=ax, device=device))
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D(layout=layout))
            self.output = Dense(classes, in_units=in_channels, device=device)

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


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` layers; ``kwargs`` go
    to :class:`ResNetV1`/:class:`ResNetV2` (``classes``, ``thumbnail``,
    ``layout``, ``device``).  ``pretrained`` is a path to a ``.params``
    file, loaded onto ``ctx`` (default: ``device``)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, str(resnet_spec.keys())))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    block_type, layers, channels = resnet_spec[num_layers]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_net_versions[version - 1](block_class, layers, channels,
                                           **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, pretrained, ctx)
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
