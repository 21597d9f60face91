"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``).

Built as the JAX package builds it: the same blocks, name scopes and
initializers (the convolutions ``Xavier(rnd_type="gaussian",
factor_type="out", magnitude=2)``, the dense layers ``"normal"``), every
shape left to the first batch, so ``mx.random.seed(n)``, ``initialize``
and one call give the JAX model's weights.  The classifier's two
``Dropout(0.5)`` draw from the call's key.  ``device`` (default the
current context, ``cuda:0``) is where the tensors are made;
``pretrained=<path>`` loads a local ``.params`` file, and
``pretrained=True`` raises: nothing is downloaded.
"""
from __future__ import annotations

from ...block import HybridBlock
from ._device import device_scope
from ...nn import HybridSequential, Conv2D, MaxPool2D, Dense, Dropout
from ....initializer import Xavier


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope(), device_scope(device):
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal",
                                    bias_initializer="zeros"))
            self.features.add(Dropout(rate=0.5))
            self.features.add(Dense(4096, activation="relu",
                                    weight_initializer="normal",
                                    bias_initializer="zeros"))
            self.features.add(Dropout(rate=0.5))
            self.output = Dense(classes, weight_initializer="normal",
                                bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        from ...nn import BatchNorm, Activation
        featurizer = HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(Conv2D(filters[i], kernel_size=3, padding=1,
                                      weight_initializer=Xavier(
                                          rnd_type="gaussian",
                                          factor_type="out", magnitude=2),
                                      bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, pretrained, ctx)
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
