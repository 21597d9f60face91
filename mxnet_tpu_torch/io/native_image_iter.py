"""The threaded native ImageRecord iterator over ``src/pipeline.cc``
(counterpart of ``mxnet_tpu/io/native_image_iter.py``, :24-161).

Reading records, JPEG decode and the resize run on the native library's
C++ threads (``_native.py``); Python receives filled uint8 batches.  Layout
``NCHW`` gives float32 batches (transposed and cast on the host), ``NHWC``
the decoder's uint8 buffer unchanged, for the card to cast and normalise
inside the step.  Batches are CPU NDArrays; staging them on the card is
the feed's work.  Records come in file order, corrupt ones are skipped and
counted (``skipped``), and a stream cut by a corrupt frame raises, a
partial last batch included.  Augmentation beyond the resize belongs to
the Python backend (``io.ImageRecordIter(backend="python")``).
"""
from __future__ import annotations

import ctypes

import numpy as _np

from .io import DataIter, DataBatch, DataDesc
from ..base import MXNetError
from ..context import cpu


class NativeImageRecordIter(DataIter):
    """Batches from a .rec file via the C++ decode pipeline.

    Parameters mirror the reference ImageRecordIter: ``path_imgrec``,
    ``data_shape`` (C, H, W), ``batch_size``, ``label_width``,
    ``preprocess_threads``, plus ``round_batch`` (pad the last batch by
    wrapping, the reference's default) and ``prefetch_capacity``.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 preprocess_threads=4, round_batch=True,
                 prefetch_capacity=256, data_name="data", label_name="softmax_label",
                 layout="NCHW", **unsupported):
        super().__init__(batch_size)
        if unsupported:
            raise MXNetError(
                "native ImageRecordIter does not support %s: augmentation "
                "and shuffle belong to the python backend (backend='python')"
                % sorted(unsupported))
        if layout not in ("NCHW", "NHWC"):
            raise ValueError("layout must be NCHW or NHWC")
        self._layout = layout
        from .._native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "mxtpu_pipe_open"):
            raise MXNetError("native pipeline unavailable (g++/libjpeg "
                             "missing); use io.ImageRecordIter backend='python'")
        self._lib = lib
        c, h, w = (int(x) for x in data_shape)
        if c not in (1, 3):
            raise MXNetError("native pipeline decodes 1 (grayscale) or 3 "
                             "(RGB) channels; got data_shape=%r" % (data_shape,))
        if int(label_width) < 1:
            raise MXNetError("label_width must be >= 1, got %r" % label_width)
        self._shape = (c, h, w)
        self._label_width = int(label_width)
        self._round_batch = round_batch
        self._data_name, self._label_name = data_name, label_name
        self._handle = lib.mxtpu_pipe_open(
            path_imgrec.encode(), w, h, c, self._label_width,
            int(preprocess_threads), int(prefetch_capacity))
        if not self._handle:
            raise MXNetError("cannot open record file %s" % path_imgrec)
        self._hwc = (h, w, c)
        self._data_buf = _np.empty((batch_size,) + self._hwc, dtype=_np.uint8)
        self._label_buf = _np.empty((batch_size, self._label_width),
                                    dtype=_np.float32)
        self._batch = None
        self._pad = 0
        self._exhausted = False

    @property
    def provide_data(self):
        if self._layout == "NHWC":
            return [DataDesc(self._data_name, (self.batch_size,) + self._hwc,
                             _np.uint8)]
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape,
                         _np.float32)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        return [DataDesc(self._label_name, shape, _np.float32)]

    def reset(self):
        self._lib.mxtpu_pipe_reset(self._handle)
        self._exhausted = False

    @property
    def skipped(self):
        """Records dropped by the decoder (corrupt/truncated JPEGs)."""
        return int(self._lib.mxtpu_pipe_skipped(self._handle))

    def iter_next(self):
        if self._exhausted:
            return False
        n = int(self._lib.mxtpu_pipe_next_batch(
            self._handle, self.batch_size,
            self._data_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))
        if n < self.batch_size:
            # stream ended (fully or mid-batch): a corrupt frame means the
            # epoch silently lost its tail — fail loudly either way
            errs = int(self._lib.mxtpu_pipe_read_errors(self._handle))
            if errs:
                raise MXNetError(
                    "corrupt RecordIO frame truncated the stream "
                    "(%d read error(s)); the epoch is incomplete" % errs)
        if n == 0:
            self._exhausted = True
            return False
        self._pad = self.batch_size - n
        if n < self.batch_size:
            self._exhausted = True
            if not self._round_batch:
                return False
            # pad by repeating the first delivered sample (reference pads
            # with wrapped data; content beyond pad is masked by `pad`)
            self._data_buf[n:] = self._data_buf[0]
            self._label_buf[n:] = self._label_buf[0]
        from ..ndarray.ndarray import array
        if self._layout == "NHWC":
            chw = self._data_buf.copy()  # buffer is reused next batch
        else:
            chw = self._data_buf.transpose(0, 3, 1, 2).astype(_np.float32)
        labels = (self._label_buf[:, 0] if self._label_width == 1
                  else self._label_buf)
        self._batch = DataBatch(
            data=[array(chw, ctx=cpu(), dtype=chw.dtype)],
            label=[array(labels, ctx=cpu())],
            pad=self._pad, index=None,
            provide_data=self.provide_data, provide_label=self.provide_label)
        return True

    def next(self):
        if self.iter_next():
            return self._batch
        raise StopIteration

    def getdata(self):
        return self._batch.data

    def getlabel(self):
        return self._batch.label

    def getpad(self):
        return self._pad

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mxtpu_pipe_close(self._handle)
                self._handle = None
        except Exception:
            pass
