"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``, :10-105)."""
from __future__ import annotations

import os

from ...ndarray import NDArray
from ... import recordio


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in (self[i] for i in range(len(self)))
                              if fn(s)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    """Applies ``fn`` at access time (no upfront materialization)."""

    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        # multi-field samples (data, label, ...) splat into the transform
        return self._fn(*item) if isinstance(item, tuple) else self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    def __init__(self, *args):
        if not args:
            raise ValueError("Needs at least 1 arrays")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, i + 1, len(data)))
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file (reference RecordFileDataset)."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file, self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
