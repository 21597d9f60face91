"""Image decode, geometry and augmentation (counterpart of
``mxnet_tpu/image/image.py``, :30-569): ``imdecode``/``imread``, the
resize and crop helpers, the augmenters and ``CreateAugmenter``,
``ImageIter`` (:429) over .rec files or image lists, and
``ImageRecordIterator`` (:549), the Python backend of
``io.ImageRecordIter``.

Decode and augmentation run on the host in numpy and PIL (no OpenCV), and
their results are CPU NDArrays; a batch comes out NCHW float32, to be
staged on the card by the feed (``io.PrefetchingIter(ctx=...)``,
``io.DeviceFeed``) or the training loop.  The augmenters draw from
Python's global ``random``, as the JAX package's do (so ``random.seed(n)``
gives both packages the same crops, flips and jitters); ``LightingAug``
draws from ``random.derived_numpy_rng()``, taken at its construction.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as _np

from .. import random as _mxrand
from .. import recordio
from ..context import cpu
from ..io.io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import NDArray, array


def _host(source, dtype=None):
    """A CPU NDArray holding ``source``."""
    return array(source, ctx=cpu(), dtype=dtype)


# ---------------------------------------------------------------------------
# decode / geometric primitives (numpy/PIL)
# ---------------------------------------------------------------------------

def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Image bytes as an HWC uint8 NDArray on the CPU."""
    img = recordio._decode_jpeg(bytes(buf), iscolor=flag)
    if img.ndim == 2:
        img = img[:, :, None]
    return _host(img.astype(_np.uint8), dtype=_np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _np_resize(src, w, h, interp=1):
    """Bilinear resize in numpy (no cv2). src: HWC uint8/float."""
    src = _np.asarray(src)
    H, W = src.shape[:2]
    if (H, W) == (h, w):
        return src.copy()
    y = _np.linspace(0, H - 1, h)
    x = _np.linspace(0, W - 1, w)
    y0 = _np.floor(y).astype(int)
    x0 = _np.floor(x).astype(int)
    y1 = _np.minimum(y0 + 1, H - 1)
    x1 = _np.minimum(x0 + 1, W - 1)
    wy = (y - y0)[:, None, None]
    wx = (x - x0)[None, :, None]
    img = src.astype(_np.float32)
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx) + img[y0][:, x1] * (1 - wy) * wx
           + img[y1][:, x0] * wy * (1 - wx) + img[y1][:, x1] * wy * wx)
    return out.astype(src.dtype)


def imresize(src, w, h, interp=1):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    return _host(_np_resize(data, w, h, interp), dtype=data.dtype)


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    h, w = data.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _host(_np_resize(data, new_w, new_h, interp), dtype=data.dtype)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    out = data[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _np_resize(out, size[0], size[1], interp)
    return _host(out, dtype=out.dtype)


def random_crop(src, size, interp=2):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    h, w = data.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(data, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    h, w = data.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(data, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, **kwargs):
    data = src.asnumpy() if isinstance(src, NDArray) else src
    h, w = data.shape[:2]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(data, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    data = src.asnumpy().astype(_np.float32) if isinstance(src, NDArray) else src.astype(_np.float32)
    mean = mean.asnumpy() if isinstance(mean, NDArray) else _np.asarray(mean)
    data = data - mean
    if std is not None:
        std = std.asnumpy() if isinstance(std, NDArray) else _np.asarray(std)
        data = data / std
    return _host(data)


# ---------------------------------------------------------------------------
# augmenters (reference image.py Augmenter classes + image_aug_default.cc)
# ---------------------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                kwargs[k] = v.asnumpy().tolist()

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, **kwargs):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        data = src.asnumpy().astype(_np.float32) * alpha
        return _host(data)


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        data = src.asnumpy().astype(_np.float32)
        gray = (data * self._coef).sum() * 3.0 / data.size
        return _host(data * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        data = src.asnumpy().astype(_np.float32)
        gray = (data * self._coef).sum(axis=2, keepdims=True)
        return _host(data * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], dtype=_np.float32)
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], dtype=_np.float32)

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], dtype=_np.float32)
        t = _np.dot(_np.dot(self.ityiq, bt), self.tyiq).T
        data = src.asnumpy().astype(_np.float32)
        return _host(_np.dot(data, t))


class ColorJitterAug(RandomOrderAug):
    """Brightness/contrast/saturation jitter, applied in random order;
    a zero strength drops that component entirely."""

    def __init__(self, brightness, contrast, saturation):
        parts = [cls(strength)
                 for cls, strength in ((BrightnessJitterAug, brightness),
                                       (ContrastJitterAug, contrast),
                                       (SaturationJitterAug, saturation))
                 if strength > 0]
        super().__init__(parts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)
        # one stream from the framework's, taken at construction on the
        # builder's thread: seed before building the pipeline
        self._rng = _mxrand.derived_numpy_rng()

    def __call__(self, src):
        alpha = self._rng.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return _host(src.asnumpy().astype(_np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = _np.asarray(mean) if mean is not None else None
        self.std = _np.asarray(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = _np.array([[0.21, 0.21, 0.21],
                              [0.72, 0.72, 0.72],
                              [0.07, 0.07, 0.07]], dtype=_np.float32)

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _host(_np.dot(src.asnumpy().astype(_np.float32), self.mat))
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _host(src.asnumpy()[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(src.asnumpy().astype(self.typ))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Build the default augmenter list (reference image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())   # float32 from here on
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = _np.asarray(mean)
        if mean.shape[0] not in (1, 3):
            raise ValueError("mean needs 1 or 3 values")
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = _np.asarray(std)
        if std.shape[0] not in (1, 3):
            raise ValueError("std needs 1 or 3 values")
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------

class ImageIter(DataIter):
    """Image iterator over .rec files or .lst image lists (reference
    image.py:1022) with augmentation, shuffle, HWC→CHW."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_root=None, path_imgrec=None, path_imglist=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "an imglist")
        self.path_root = path_root
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
        elif path_imglist:
            imglist_d = {}
            with open(path_imglist) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    label = _np.array([float(i) for i in line[1:-1]], dtype=_np.float32)
                    imglist_d[int(line[0])] = (label, line[-1])
            self.imglist = imglist_d
            self.imgidx = list(imglist_d.keys())
        else:
            imglist_d = {}
            for i, (label, fname) in enumerate(imglist):
                imglist_d[i] = (_np.array(label, dtype=_np.float32).reshape(-1), fname)
            self.imglist = imglist_d
            self.imgidx = list(imglist_d.keys())
        self.shuffle = shuffle
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        if num_parts > 1 and self.imgidx is not None:
            n = len(self.imgidx) // num_parts
            self.imgidx = self.imgidx[part_index * n:(part_index + 1) * n]
        self.auglist = aug_list if aug_list is not None else CreateAugmenter(
            data_shape, **{k: v for k, v in kwargs.items()
                           if k in ("resize", "rand_crop", "rand_resize", "rand_mirror",
                                    "mean", "std", "brightness", "contrast",
                                    "saturation", "hue", "pca_noise", "rand_gray",
                                    "inter_method")})
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,))] if self.label_width == 1 \
            else [DataDesc(self.label_name, (self.batch_size, self.label_width))]

    def reset(self):
        self.cur = 0
        if self.imgidx is not None:
            self.seq = list(self.imgidx)
            if self.shuffle:
                _pyrandom.shuffle(self.seq)
        elif self.imgrec is not None:
            self.imgrec.reset()

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root or "", fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = _np.zeros((batch_size, h, w, c), dtype=_np.float32)
        batch_label = _np.zeros((batch_size,) if self.label_width == 1
                                else (batch_size, self.label_width), dtype=_np.float32)
        i = 0
        while i < batch_size:
            try:
                label, s = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                break
            data = recordio._decode_jpeg(bytes(s)) if not isinstance(s, _np.ndarray) else s
            if data.ndim == 2:
                data = data[:, :, None]
            img = _host(data)
            for aug in self.auglist:
                img = aug(img)
            npimg = img.asnumpy() if isinstance(img, NDArray) else img
            batch_data[i] = npimg.astype(_np.float32)
            batch_label[i] = label if _np.ndim(label) else float(label)
            i += 1
        pad = batch_size - i
        data_nchw = _np.transpose(batch_data, (0, 3, 1, 2))
        return DataBatch(data=[_host(data_nchw)], label=[_host(batch_label)], pad=pad)


class ImageRecordIterator(ImageIter):
    """Keyword-compatible shim for mx.io.ImageRecordIter(**kwargs)."""

    def __init__(self, path_imgrec=None, data_shape=(3, 224, 224), batch_size=128,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0, mean_g=0, mean_b=0, std_r=0, std_g=0, std_b=0,
                 resize=0, label_width=1, **kwargs):
        mean = None
        if mean_r or mean_g or mean_b:
            mean = _np.array([mean_r, mean_g, mean_b])
        std = None
        if std_r or std_g or std_b:
            std = _np.array([std_r or 1, std_g or 1, std_b or 1])
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         label_width=label_width, path_imgrec=path_imgrec,
                         shuffle=shuffle, rand_crop=rand_crop,
                         rand_mirror=rand_mirror, mean=mean, std=std,
                         resize=resize,
                         **{k: v for k, v in kwargs.items()
                            if k in ("path_imgidx", "path_imglist", "path_root",
                                     "part_index", "num_parts", "aug_list")})
