"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
