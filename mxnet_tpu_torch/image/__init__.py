"""Image IO and augmentation (counterpart of ``mxnet_tpu/image``)."""
from .image import (imdecode, imread, imresize, scale_down, resize_short,
                    fixed_crop, random_crop, center_crop, color_normalize,
                    random_size_crop, Augmenter, SequentialAug, RandomOrderAug,
                    ResizeAug, ForceResizeAug, RandomCropAug, RandomSizedCropAug,
                    CenterCropAug, BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, HueJitterAug, ColorJitterAug,
                    LightingAug, ColorNormalizeAug, RandomGrayAug,
                    HorizontalFlipAug, CastAug, CreateAugmenter, ImageIter,
                    ImageRecordIterator)
from . import detection  # noqa: F401
