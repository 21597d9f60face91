"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``): the JAX model's
blocks and names, its ceil-mode pools and fixed 13 x 13 average pool, so
it runs at 224 x 224 as there.  ``device`` and ``pretrained`` as in
``vgg.py``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ._device import device_scope
from ...nn import (HybridSequential, Conv2D, MaxPool2D, Dropout, AvgPool2D,
                   Flatten, Activation)


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    left = _make_fire_conv(expand1x1_channels, 1)
    right = _make_fire_conv(expand3x3_channels, 3, 1)

    class Fire(HybridBlock):
        def __init__(self):
            super().__init__(prefix="")
            from ...nn.conv_layers import default_batchnorm_axis
            self._channel_axis = default_batchnorm_axis()
            self.squeeze = out
            self.left = left
            self.right = right

        def hybrid_forward(self, F, x):
            x = self.squeeze(x)
            return F.concat(self.left(x), self.right(x),
                            dim=self._channel_axis)

    return Fire()


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(**kwargs)
        assert version in ["1.0", "1.1"], \
            "Unsupported SqueezeNet version {version}: 1.0 or 1.1 expected".format(
                version=version)
        with self.name_scope(), device_scope(device):
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, kernel_size=7, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(Conv2D(64, kernel_size=3, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1))
            self.output.add(Activation("relu"))
            self.output.add(AvgPool2D(13))
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, pretrained, ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
