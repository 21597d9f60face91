"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``): the JAX model's
branches and names; its final 8 x 8 average pool fixes the input at
299 x 299, as there.  ``device`` and ``pretrained`` as in ``vgg.py``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ._device import device_scope
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation, MaxPool2D,
                   AvgPool2D, GlobalAvgPool2D, Dropout, Flatten, Dense)


def _make_basic_conv(**kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Run child branches on the same input and concat on channel axis."""

    def __init__(self, prefix=""):
        super().__init__(prefix=prefix)
        from ...nn.conv_layers import default_batchnorm_axis
        self._channel_axis = default_batchnorm_axis()

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._modules.values()],
                        dim=self._channel_axis)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)),
                         (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _BranchE(HybridBlock):
    def __init__(self, prefix=""):
        super().__init__(prefix=prefix)
        from ...nn.conv_layers import default_batchnorm_axis
        self._channel_axis = default_batchnorm_axis()
        self.base = None
        self.left = None
        self.right = None

    def hybrid_forward(self, F, x):
        if self.base is not None:
            x = self.base(x)
        return F.concat(self.left(x), self.right(x), dim=self._channel_axis)


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (320, 1, None, None)))

    b1 = _BranchE()
    b1.base = _make_branch(None, (384, 1, None, None))
    b1.left = _make_branch(None, (384, (1, 3), None, (0, 1)))
    b1.right = _make_branch(None, (384, (3, 1), None, (1, 0)))
    out.add(b1)

    b2 = _BranchE()
    b2.base = _make_branch(None, (448, 1, None, None), (384, 3, None, 1))
    b2.left = _make_branch(None, (384, (1, 3), None, (0, 1)))
    b2.right = _make_branch(None, (384, (3, 1), None, (1, 0)))
    out.add(b2)

    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(**kwargs)
        with self.name_scope(), device_scope(device):
            self.features = HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(AvgPool2D(pool_size=8))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, pretrained, ctx)
    return net
