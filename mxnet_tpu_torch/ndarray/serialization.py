"""The binary NDArray file format (counterpart of
``mxnet_tpu/ndarray/serialization.py``): MXNet's ``NDArray::Save``/
``Load`` layout, V2 (magic ``0xF993fac9``) written, V2, V1
(``0xF993fac8``) and the legacy pre-V1 layout read, in the list container
``0x112``.  The files are byte for byte those the JAX package writes for
the same arrays, so either package loads the other's.

Layout (little-endian)::

  file   := uint64 0x112 | uint64 0 | vec<array> | vec<string>
  vec<T> := uint64 count | T*count
  string := uint64 len | bytes
  array  := uint32 V2_MAGIC | int32 stype | shape | int32 dev_type
          | int32 dev_id | int32 type_flag | raw data bytes
  shape  := uint32 ndim | int64*ndim          (V2/V1; legacy: uint32 dims)

Arrays are numpy arrays here; ``ndarray/utils.py`` turns them into
NDArrays.  bf16 has no type flag and is written as float32, as the JAX
package writes it; 64-bit arrays are narrowed first (``nd.array``), as the
JAX package runs without x64.  Sparse storage types raise until the port
of ``ndarray/sparse.py``.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..util import write_atomic

__all__ = ["NDARRAY_V1_MAGIC", "NDARRAY_V2_MAGIC", "LIST_MAGIC",
           "serialize_ndarray", "deserialize_ndarray", "save_list",
           "load_list", "is_reference_format"]

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
LIST_MAGIC = 0x112

# mshadow type flags (mshadow/base.h)
_TYPE_FLAG_TO_DTYPE = {
    0: np.float32, 1: np.float64, 2: np.float16,
    3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64,
}
_DTYPE_TO_TYPE_FLAG = {np.dtype(v): k for k, v in _TYPE_FLAG_TO_DTYPE.items()}
_STYPE_DEFAULT = 0


def _read(buf, off, fmt):
    vals = struct.unpack_from("<" + fmt, buf, off)
    return vals, off + struct.calcsize("<" + fmt)


def _read_shape(buf, off, int64=True):
    (ndim,), off = _read(buf, off, "I")
    if ndim == 0:
        return (), off
    dims, off = _read(buf, off, ("%dq" if int64 else "%dI") % ndim)
    return tuple(int(d) for d in dims), off


def _host_array(arr):
    """``arr`` (an NDArray, a tensor or a numpy array) as a numpy array on
    the host, bf16 widened to float32 exactly."""
    if not isinstance(arr, (np.ndarray, torch.Tensor)):
        if getattr(arr, "stype", "default") != "default":
            raise ValueError("sparse storage is not ported yet: cannot "
                             "serialize storage type %r" % arr.stype)
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    return np.asarray(arr)


def serialize_ndarray(arr):
    """One array -> bytes in the V2 layout."""
    data = _host_array(arr)
    if data.ndim == 0:
        # ndim 0 on the wire means an empty array, which carries no data
        raise ValueError("0-d arrays cannot be serialized in the reference "
                         "format; reshape to (1,) first")
    flag = _DTYPE_TO_TYPE_FLAG.get(data.dtype)
    if flag is None:
        raise ValueError("dtype %s has no reference serialization code"
                         % data.dtype)
    return b"".join([
        struct.pack("<Ii", NDARRAY_V2_MAGIC, _STYPE_DEFAULT),
        struct.pack("<I", data.ndim),
        struct.pack("<%dq" % data.ndim, *data.shape),
        struct.pack("<ii", 1, 0),             # context: cpu, id 0
        struct.pack("<i", flag),
        np.ascontiguousarray(data).tobytes()])


def deserialize_ndarray(buf, off):
    """bytes at ``off`` -> (numpy array, new offset); V2, V1 or legacy."""
    (magic,), off = _read(buf, off, "I")
    if magic == NDARRAY_V2_MAGIC:
        (stype,), off = _read(buf, off, "i")
        if stype != _STYPE_DEFAULT:
            raise ValueError("sparse storage (stype %d) is not ported yet"
                             % stype)
        shape, off = _read_shape(buf, off)
    elif magic == NDARRAY_V1_MAGIC:
        shape, off = _read_shape(buf, off)
    else:
        # legacy: the magic is ndim, and the dims are uint32
        ndim = magic
        dims, off = _read(buf, off, "%dI" % ndim) if ndim else ((), off)
        shape = tuple(int(d) for d in dims)
    if len(shape) == 0:
        return np.zeros((), np.float32), off
    (_dev_type, _dev_id), off = _read(buf, off, "ii")
    (type_flag,), off = _read(buf, off, "i")
    dtype = np.dtype(_TYPE_FLAG_TO_DTYPE[type_flag])
    count = int(np.prod(shape))
    data = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
    return data.reshape(shape).copy(), off + count * dtype.itemsize


def save_list(fname, arrays, names):
    """Write the ``0x112`` list container of ``arrays`` (and ``names``,
    empty for the list form) to ``fname``, atomically."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    out += [serialize_ndarray(a) for a in arrays]
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out += [struct.pack("<Q", len(b)), b]
    write_atomic(fname, b"".join(out))


def load_list(buf):
    """Parse the ``0x112`` list container -> (numpy arrays, names)."""
    (magic, _reserved), off = _read(buf, 0, "QQ")
    if magic != LIST_MAGIC:
        raise ValueError("not a reference NDArray file (bad magic 0x%x)"
                         % magic)
    (n,), off = _read(buf, off, "Q")
    arrays = []
    for _ in range(n):
        arr, off = deserialize_ndarray(buf, off)
        arrays.append(arr)
    (n_names,), off = _read(buf, off, "Q")
    names = []
    for _ in range(n_names):
        (ln,), off = _read(buf, off, "Q")
        names.append(buf[off:off + ln].decode("utf-8"))
        off += ln
    return arrays, names


def is_reference_format(buf):
    head = bytes(buf[:8])
    return len(head) == 8 and struct.unpack("<Q", head)[0] == LIST_MAGIC
