"""Detection augmenters (counterpart of ``mxnet_tpu/image/detection.py``,
:15-72): ``DetBorrowAug``, ``DetHorizontalFlipAug``,
``DetRandomSelectAug`` and ``CreateDetAugmenter``, drawing from Python's
global ``random`` as the JAX package's do.  Images are CPU NDArrays."""
from __future__ import annotations

import random as _pyrandom

from ..ndarray.ndarray import NDArray
from .image import _host


class DetAugmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter for detection (label unchanged)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps() if hasattr(augmenter, "dumps") else "")
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            data = src.asnumpy() if isinstance(src, NDArray) else src
            src = _host(data[:, ::-1].copy())
            label = label.copy()
            tmp = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


class DetRandomSelectAug(DetAugmenter):
    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _pyrandom.random() < self.skip_prob:
            return src, label
        aug = _pyrandom.choice(self.aug_list)
        return aug(src, label)


def CreateDetAugmenter(data_shape, rand_mirror=False, mean=None, std=None,
                       **kwargs):
    auglist = []
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    from .image import CastAug, ColorNormalizeAug
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist
