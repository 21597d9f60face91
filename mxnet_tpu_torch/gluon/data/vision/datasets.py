"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``, :22-197).

The loaders read files staged under ``root`` (MNIST idx files, CIFAR
binary batches, .rec records, image folders) and raise when they are
absent, as the JAX package's do: nothing is downloaded.  Samples are CPU
NDArrays (a DataLoader's fork workers never touch the card)."""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as _np

from ..dataset import Dataset, RecordFileDataset
from .... import recordio
from ....base import data_dir
from ....image.image import _host


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(_host(self._data[idx]), self._label[idx])
        return _host(self._data[idx]), self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    def __init__(self, root=os.path.join(data_dir(), "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", None)
        self._train_label = ("train-labels-idx1-ubyte.gz", None)
        self._test_data = ("t10k-images-idx3-ubyte.gz", None)
        self._test_label = ("t10k-labels-idx1-ubyte.gz", None)
        self._namespace = "mnist"
        super().__init__(root, transform)

    def _get_data(self):
        if self._train:
            data_file, label_file = self._train_data[0], self._train_label[0]
        else:
            data_file, label_file = self._test_data[0], self._test_label[0]
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        for p in (data_path, label_path):
            base = os.path.splitext(p)[0]
            if not os.path.exists(p) and not os.path.exists(base):
                raise FileNotFoundError(
                    "MNIST file %s not found; stage the idx files under %s "
                    "(no-egress environment: download() disabled)" % (p, self._root))

        def read(path, is_label):
            if not os.path.exists(path):
                path = os.path.splitext(path)[0]
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                if is_label:
                    struct.unpack(">II", f.read(8))
                    return _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)
                _, _, rows, cols = struct.unpack(">IIII", f.read(16))
                data = _np.frombuffer(f.read(), dtype=_np.uint8)
                return data.reshape(-1, rows, cols, 1)

        self._label = read(label_path, True)
        self._data = read(data_path, False)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join(data_dir(), "datasets", "fashion-mnist"),
                 train=True, transform=None):
        self._namespace = "fashion-mnist"
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=os.path.join(data_dir(), "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._archive_file = ("cifar-10-binary.tar.gz", None)
        self._train_data = [("data_batch_%d.bin" % i, None) for i in range(1, 6)]
        self._test_data = [("test_batch.bin", None)]
        self._namespace = "cifar10"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(_np.int32)

    def _get_data(self):
        files = self._train_data if self._train else self._test_data
        paths = [os.path.join(self._root, f[0]) for f in files]
        # allow nested cifar-10-batches-bin dir
        paths = [p if os.path.exists(p) else
                 os.path.join(self._root, "cifar-10-batches-bin", os.path.basename(p))
                 for p in paths]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    "CIFAR10 file %s not found; stage the binary batches under %s"
                    % (p, self._root))
        data, label = zip(*(self._read_batch(p) for p in paths))
        self._data = _np.concatenate(data)
        self._label = _np.concatenate(label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join(data_dir(), "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._archive_file = ("cifar-100-binary.tar.gz", None)
        self._train_data = [("train.bin", None)]
        self._test_data = [("test.bin", None)]
        self._namespace = "cifar100"
        _DownloadedDataset.__init__(self, root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3072 + 2)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 + self._fine_label].astype(_np.int32)


class ImageRecordDataset(RecordFileDataset):
    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        from ....image import imdecode
        decoded = imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(decoded, header.label)
        return decoded, header.label


class ImageFolderDataset(Dataset):
    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path,
                              stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn("Ignoring %s of type %s. Only support %s"
                                  % (filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, float(label)))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
