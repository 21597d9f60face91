"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``): the JAX model's dense
blocks, transitions and names, concatenating on the channel axis taken at
construction.  ``device`` and ``pretrained`` as in ``vgg.py``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ._device import device_scope
from ...nn import (HybridSequential, Conv2D, MaxPool2D, AvgPool2D, BatchNorm,
                   Activation, Dense, GlobalAvgPool2D, Flatten, Dropout)
from ...nn.conv_layers import default_batchnorm_axis


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__(prefix="")
        # channel axis captured at construction (1, or -1 under
        # nn.channels_last()) — dense connectivity concats features there
        self._channel_axis = default_batchnorm_axis()
        self.body = HybridSequential(prefix="")
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
        if dropout:
            self.body.add(Dropout(dropout))

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return F.concat(x, out, dim=self._channel_axis)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index):
    out = HybridSequential(prefix="stage%d_" % stage_index)
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm())
    out.add(Activation("relu"))
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(**kwargs)
        with self.name_scope(), device_scope(device):
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(num_layers, bn_size,
                                                    growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features = num_features // 2
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, pretrained, ctx)
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
