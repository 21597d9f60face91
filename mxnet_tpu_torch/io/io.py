"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc``,
``DataBatch`` and ``DataIter``, :28-178; ``NDArrayIter``, :335-440).

:class:`NDArrayIter` keeps its arrays as tensors on ``ctx`` (default
``context.current_context()``, ``cuda:0``; the arrays' own device for
NDArrays and tensors), and hands out each batch as NDArrays gathered there.
It shuffles on the host through ``random.derived_numpy_rng()``, once at
construction and again at each ``reset``, exactly as the JAX iterator
does, so the same ``mx.random.seed(n)`` gives the same batch order in both
packages.  ``last_batch_handle`` is ``pad`` (the last batch wraps to the
start; ``getpad`` says by how many), ``discard`` or ``roll_over``.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .. import random as _mxrand
from ..base import tensor_from_numpy
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, torch_dtype

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """A data source's name and shape, with its dtype and layout as
    attributes."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        desc = super().__new__(cls, name, shape)
        desc.dtype, desc.layout = dtype, layout
        return desc

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch: lists of data and label NDArrays, and ``pad``, the
    number of wrapped rows at its end."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        for field, value in (("data", data), ("label", label)):
            if value is not None and not isinstance(value, (list, tuple)):
                raise TypeError("DataBatch %s must be a list/tuple of "
                                "NDArrays, got %s" % (field, type(value)))
        self.data, self.label = data, label
        self.pad, self.index = pad, index
        self.bucket_key = bucket_key
        self.provide_data, self.provide_label = provide_data, provide_label

    def __str__(self):
        def shapes(arrs):
            return [a.shape for a in arrs] if arrs else None
        return "%s: data shapes: %s label shapes: %s" % (
            type(self).__name__, shapes(self.data), shapes(self.label))


class DataIter:
    """Base iterator: ``next()`` (or iteration) gives :class:`DataBatch`es
    built from ``iter_next``/``getdata``/``getlabel``/``getpad``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name, device):
    """``data`` as a sorted list of (name, tensor on its device)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must be given")
        data = []
    if isinstance(data, (np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            t = v._data.detach()
        elif isinstance(v, torch.Tensor):
            t = v.detach()
        else:
            t = tensor_from_numpy(np.asarray(v))
            t = t.to(resolve_device(device), torch_dtype(t.dtype))
        out[k] = t
    return sorted(out.items())


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, shuffled by the framework's seeded
    stream; see the module docstring.  ``ctx`` (a port extension) places
    numpy inputs."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx=None):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name, ctx)
        self.label = _init_data(label, True, label_name, ctx)
        n = self.data[0][1].shape[0]
        self.idx = np.arange(n)
        if shuffle:
            _mxrand.derived_numpy_rng().shuffle(self.idx)
        if last_batch_handle == "discard":
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         _numpy_dtype(v)) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         _numpy_dtype(v)) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            _mxrand.derived_numpy_rng().shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise AssertionError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        out = []
        for _, t in data_source:
            index = torch.from_numpy(sel).to(t.device, non_blocking=True)
            out.append(NDArray(t.index_select(0, index)))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _numpy_dtype(t):
    return NDArray(t[:0]).dtype
