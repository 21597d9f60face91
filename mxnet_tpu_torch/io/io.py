"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc``,
``DataBatch`` and ``DataIter`` with its ``next()`` adapter, :28-171;
``ResizeIter`` :174, ``PrefetchingIter`` :240, ``NDArrayIter`` :335-440,
``CSVIter`` :423, ``MNISTIter`` :454, ``ImageRecordIter`` :500-532,
``LibSVMIter`` :535 and ``DataLoaderIter`` :586).

:class:`NDArrayIter` keeps its arrays as tensors on ``ctx`` (default
``context.current_context()``, ``cuda:0``; the arrays' own device for
NDArrays and tensors), and hands out each batch as NDArrays gathered there.
It shuffles on the host through ``random.derived_numpy_rng()``, once at
construction and again at each ``reset``, exactly as the JAX iterator
does, so the same ``mx.random.seed(n)`` gives the same batch order in both
packages.  ``last_batch_handle`` is ``pad`` (the last batch wraps to the
start; ``getpad`` says by how many), ``discard`` or ``roll_over``.
``CSVIter`` and ``MNISTIter`` read their files into one and take its
``ctx`` (a port extension, as on ``NDArrayIter``).  They name their
streams as MXNet's C++ iterators do, ``data`` and ``softmax_label``
(``data_name``/``label_name``): the JAX package's name the labels
``label``, which no ``SoftmaxOutput`` symbol binds, so its
``train_mnist.py`` fails on staged files with ``KeyError: 'label'``.

``PrefetchingIter`` runs its sources on a ``DeviceFeed`` thread
(``io/device_feed.py``), staging each batch on ``ctx`` when one is given.
The image iterators decode on the host and hand out CPU NDArrays: placing
a batch on the card is the feed's work, or the training loop's.
``LibSVMIter`` yields CSR arrays, which wait for ROADMAP queue 1 #9: it
raises.
"""
from __future__ import annotations

import functools
import gzip
import logging
import struct
from collections import namedtuple

import numpy as np
import torch

from .. import random as _mxrand
from ..base import MXNetError, tensor_from_numpy
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, torch_dtype

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "ImageRecordIter", "LibSVMIter", "DataLoaderIter"]


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
    built from ``iter_next``/``getdata``/``getlabel``/``getpad``.

    A subclass implements either that accessor protocol or ``next()``; for
    one that defines only ``next()``, ``iter_next`` caches the batch that
    ``next()`` gives and the accessors read it (the JAX package's adapter,
    :130-171).  Drive one instance through one protocol: both consume the
    same stream, so mixing them skips batches.  ``reset`` drops the cached
    batch, in every subclass (``__init_subclass__`` wraps its ``reset``).
    """

    def __init__(self, batch_size=0):
        self.batch_size = batch_size
        self._current_batch = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        r = cls.__dict__.get("reset")
        if r is not None:
            @functools.wraps(r)
            def reset(self, *a, _wrapped=r, **k):
                out = _wrapped(self, *a, **k)
                self._current_batch = None
                return out

            cls.reset = reset

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
        if type(self).next is DataIter.next:
            raise NotImplementedError(
                "%s implements neither iter_next() nor next()"
                % type(self).__name__)
        try:
            self._current_batch = self.next()
        except StopIteration:
            self._current_batch = None
            return False
        return True

    def _adapter_batch(self):
        if self._current_batch is None:
            raise RuntimeError("no current batch: call iter_next() (and get "
                               "True) before the batch accessors")
        return self._current_batch

    def getdata(self):
        return self._adapter_batch().data

    def getlabel(self):
        return self._adapter_batch().label

    def getindex(self):
        if self._current_batch is None:
            return None
        return getattr(self._current_batch, "index", None)

    def getpad(self):
        return self._adapter_batch().pad


class ResizeIter(DataIter):
    """Another iterator's epoch cut or stretched to exactly ``size``
    batches, resetting the source when it runs dry mid-epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(batch_size=data_iter.batch_size)
        self.data_iter, self.size = data_iter, size
        self.reset_internal = reset_internal
        self.cur, self.current_batch = 0, None
        for attr in ("provide_data", "provide_label", "default_bucket_key"):
            if hasattr(data_iter, attr):
                setattr(self, attr, getattr(data_iter, attr))

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        self.cur += 1
        try:
            self.current_batch = self.data_iter.next()
            return True
        except StopIteration:
            pass
        self.data_iter.reset()
        self.current_batch = self.data_iter.next()
        return True

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return self.current_batch

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _pull_all(iters):
    """One list of batches a step, on the feed thread.  A module function:
    the thread must hold no reference to the PrefetchingIter, so that an
    abandoned one stays collectable."""
    while True:
        try:
            yield [i.next() for i in iters]
        except StopIteration:
            return


class PrefetchingIter(DataIter):
    """Runs one or more iterators ``capacity`` batches ahead on a
    ``DeviceFeed`` thread (one single-pass feed an epoch; ``reset`` starts
    a new one).  A source's error is raised in the consumer after the
    batches before it.  With ``ctx``, each batch is staged there on the
    feed thread (``device_feed.stage_batch``: pinned host memory and a copy
    on the feed's CUDA stream), so the consumer waits for neither decode
    nor the copy."""

    def __init__(self, iters, rename_data=None, rename_label=None, capacity=2,
                 ctx=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        if not self.iters:
            raise ValueError("PrefetchingIter needs at least one source iter")
        self.n_iter = len(self.iters)
        self.rename_data, self.rename_label = rename_data, rename_label
        self.batch_size = self.provide_data[0][1][0]
        self._ctx = ctx
        self._capacity = capacity
        self._start()

    @staticmethod
    def _renamed(descs, renames):
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
                     for x in d] for r, d in zip(renames, descs)], [])

    @property
    def provide_data(self):
        descs = [i.provide_data for i in self.iters]
        if self.rename_data is None:
            return sum(descs, [])
        return self._renamed(descs, self.rename_data)

    @property
    def provide_label(self):
        descs = [i.provide_label for i in self.iters]
        if self.rename_label is None:
            return sum(descs, [])
        return self._renamed(descs, self.rename_label)

    def _start(self):
        from .device_feed import DeviceFeed
        self._feed = DeviceFeed(_pull_all(self.iters), ctx=self._ctx,
                                depth=self._capacity, name="prefetch",
                                stage=self._ctx is not None)

    def reset(self):
        self._feed.close()
        for i in self.iters:
            i.reset()
        self._start()

    def close(self):
        """Stop the feed thread (idempotent; also run when collected)."""
        self._feed.close()

    def stats(self):
        """The current epoch's feed totals (``DeviceFeed.stats``)."""
        return self._feed.stats()

    def next(self):
        batches = self._feed.next()
        if self.n_iter == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([b.label for b in batches], []),
                         pad=batches[0].pad, index=batches[0].index)


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


class _FileIter(DataIter):
    """An :class:`NDArrayIter` over arrays read from files."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(_FileIter):
    """Rows of a CSV file as data (and of another as labels), in file
    order; ``round_batch`` pads the last batch by wrapping, else drops it.
    ``ctx`` places the arrays (a port extension; default the current
    context)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, data_name="data",
                 label_name="softmax_label", ctx=None, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name=data_name, label_name=label_name, ctx=ctx)


def _read_idx(path):
    """An idx file (MNIST's format, gzipped or not) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, dims = struct.unpack(">HBB", f.read(4))
        shape = tuple(struct.unpack(">I", f.read(4))[0] for _ in range(dims))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTIter(_FileIter):
    """MNIST's idx files as float32 images in [0, 1] (N x 1 x 28 x 28, or
    N x 784 with ``flat``) and float32 labels, shuffled by the framework's
    stream as :class:`NDArrayIter` shuffles.  ``ctx`` places the arrays (a
    port extension; default the current context)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, input_shape=None, data_name="data",
                 label_name="softmax_label", ctx=None, **kwargs):
        super().__init__(batch_size)
        img = _read_idx(image).astype(np.float32) / 255.0
        lbl = _read_idx(label).astype(np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter(img, lbl, batch_size=batch_size,
                                  shuffle=shuffle, data_name=data_name,
                                  label_name=label_name, ctx=ctx)


_NATIVE_ITER_KWARGS = {"path_imgrec", "data_shape", "batch_size",
                       "label_width", "preprocess_threads", "round_batch",
                       "prefetch_capacity", "data_name", "label_name",
                       "layout"}


def ImageRecordIter(backend="auto", **kwargs):
    """Images from a RecordIO file (MXNet's ``ImageRecordIter``).

    ``backend="native"`` decodes in the native library's threads
    (``NativeImageRecordIter``, resize only); ``"python"`` reads through
    ``image.ImageRecordIterator`` with the augmenters; ``"auto"`` takes the
    native one when only its keywords are given and it builds, else falls
    back to Python with a logged warning, unless a keyword that changes the
    batches' contract (layout, names, no padding) was set."""
    if backend in ("auto", "native"):
        trivial = set(kwargs) <= _NATIVE_ITER_KWARGS
        if backend == "native" or trivial:
            try:
                from .native_image_iter import NativeImageRecordIter
                return NativeImageRecordIter(**kwargs)
            except Exception:
                if backend == "native":
                    raise
                defaults = {"layout": "NCHW", "data_name": "data",
                            "label_name": "softmax_label", "round_batch": True}
                changed = [k for k, dflt in defaults.items()
                           if k in kwargs and kwargs[k] != dflt]
                if changed:
                    raise
                logging.getLogger(__name__).warning(
                    "native image pipeline unavailable; falling back to the "
                    "python ImageIter backend")
    from ..image.image import ImageRecordIterator
    return ImageRecordIterator(**kwargs)


class LibSVMIter(DataIter):
    """LibSVM files as CSR batches: waits for the sparse arrays of ROADMAP
    queue 1 #9."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("io.LibSVMIter yields CSRNDArrays, which are not "
                         "ported yet (ROADMAP queue 1 #9)")


class DataLoaderIter(DataIter):
    """A Gluon ``DataLoader`` as a :class:`DataIter`: each ``(data,
    label)`` batch as a :class:`DataBatch`."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        super().__init__()
        self._loader = loader
        self._iter = iter(loader)
        self._data_name = data_name
        self._label_name = label_name

    def reset(self):
        self._iter = iter(self._loader)

    def next(self):
        data, label = next(self._iter)
        if not isinstance(data, (list, tuple)):
            data = [data]
        if not isinstance(label, (list, tuple)):
            label = [label]
        return DataBatch(data=list(data), label=list(label), pad=0)
