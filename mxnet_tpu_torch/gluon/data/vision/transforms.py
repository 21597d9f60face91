"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, :12-186).

Each transform is a Block over an HWC image: called with an NDArray it
returns one, called with a tensor a tensor (Gluon's boundary).  They run
on the host, as a dataset's ``transform``; the geometric and colour ones
go through ``image``'s numpy functions and augmenters and draw from
Python's global ``random`` (``RandomLighting`` from the framework's
stream), as the JAX package's do.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as _np
import torch

from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential
from ....ndarray.ndarray import NDArray
from .... import image as _image

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


class Compose(Sequential):
    """Chain transforms; consecutive HybridBlocks are grouped into one
    HybridSequential."""

    def __init__(self, transforms):
        super().__init__()
        transforms = list(transforms) + [None]
        hybrid = []

        def flush():
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif hybrid:
                fused = HybridSequential()
                for j in hybrid:
                    fused.add(j)
                self.add(fused)
            del hybrid[:]

        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            flush()
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        data = x.to(torch.float32) / 255.0
        return data.permute(2, 0, 1) if data.dim() == 3 else data


class Normalize(HybridBlock):
    def __init__(self, mean, std):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def hybrid_forward(self, F, x):
        mean = torch.from_numpy(self._mean.reshape((-1, 1, 1)))
        std = torch.from_numpy(self._std.reshape((-1, 1, 1)))
        return (x - mean.to(x.device)) / std.to(x.device)


class _ImageBlock(Block):
    """A Block over one of ``image``'s functions of an NDArray."""

    def _apply(self, x):
        raise NotImplementedError

    def forward(self, x):
        return self._apply(NDArray(x))._data


class Resize(_ImageBlock):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._interpolation = interpolation

    def _apply(self, x):
        return _image.imresize(x, self._size[0], self._size[1],
                               self._interpolation)


class CenterCrop(_ImageBlock):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._interpolation = interpolation

    def _apply(self, x):
        return _image.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(_ImageBlock):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._args = ((size, size) if isinstance(size, int) else size,
                      scale, ratio, interpolation)

    def _apply(self, x):
        return _image.random_size_crop(x, *self._args)[0]


class RandomFlipLeftRight(HybridBlock):
    def hybrid_forward(self, F, x):
        if _pyrandom.random() < 0.5:
            return torch.flip(x, [1])
        return x


class RandomFlipTopBottom(HybridBlock):
    def hybrid_forward(self, F, x):
        if _pyrandom.random() < 0.5:
            return torch.flip(x, [0])
        return x


class _AugBlock(_ImageBlock):
    """A Block over one of ``image``'s augmenters."""

    def _apply(self, x):
        return self._aug(x)


class RandomBrightness(_AugBlock):
    def __init__(self, brightness):
        super().__init__()
        self._aug = _image.BrightnessJitterAug(brightness)


class RandomContrast(_AugBlock):
    def __init__(self, contrast):
        super().__init__()
        self._aug = _image.ContrastJitterAug(contrast)


class RandomSaturation(_AugBlock):
    def __init__(self, saturation):
        super().__init__()
        self._aug = _image.SaturationJitterAug(saturation)


class RandomHue(_AugBlock):
    def __init__(self, hue):
        super().__init__()
        self._aug = _image.HueJitterAug(hue)


class RandomColorJitter(_AugBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        # the JAX package's: ``hue`` is accepted and not applied
        self._aug = _image.ColorJitterAug(brightness, contrast, saturation)


class RandomLighting(_AugBlock):
    def __init__(self, alpha):
        super().__init__()
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        self._aug = _image.LightingAug(alpha, eigval, eigvec)
