"""``nd.save`` and ``nd.load`` (counterpart of
``mxnet_tpu/ndarray/utils.py``, :20-60), in the binary format of
``serialization.py``, which both packages write byte for byte alike.

``load`` makes its NDArrays on ``ctx`` (default
``context.current_context()``, ``cuda:0``); :func:`load_numpy` reads the
file into numpy arrays on the host, for loaders that place the arrays
themselves (``load_parameters``).  A file in the ``.npz`` container that
earlier versions of the JAX package wrote loads too.
"""
from __future__ import annotations

import io

import numpy as np

from . import serialization as _ser
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_numpy"]

_LIST_PREFIX = "__mx_list__:"


def save(fname, data):
    """Write an NDArray, a list of them or a dict of them (tensors and numpy
    arrays are accepted too) to ``fname``."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise TypeError("data must be NDArray, list of NDArray, or dict of "
                        "NDArray")
    _ser.save_list(fname, arrays, names)


def load_numpy(fname):
    """The arrays of ``fname`` as numpy arrays: a dict by name, or a list
    for a file saved without names.  64-bit arrays narrow to 32 bits, as an
    NDArray holds them."""
    with open(fname, "rb") as f:
        buf = f.read()
    if _ser.is_reference_format(buf):
        arrays, names = _ser.load_list(buf)
        arrays = [_narrow(a) for a in arrays]
        return dict(zip(names, arrays)) if names else arrays
    if buf[:2] != b"PK":
        raise ValueError("%s is neither the reference binary NDArray format "
                         "(magic 0x112) nor an npz container" % fname)
    with np.load(io.BytesIO(buf), allow_pickle=False) as npz:
        keys = list(npz.keys())
        if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
            return [_narrow(v) for _, v in sorted(
                (int(k[len(_LIST_PREFIX):]), npz[k]) for k in keys)]
        return {k: _narrow(npz[k]) for k in keys}


def _narrow(a):
    name = {"float64": np.float32, "int64": np.int32}.get(a.dtype.name)
    return a if name is None else a.astype(name)


def load(fname, ctx=None):
    """The NDArrays saved in ``fname`` (a dict by name, or a list), on
    ``ctx``."""
    loaded = load_numpy(fname)
    if isinstance(loaded, dict):
        return {k: array(v, ctx=ctx) for k, v in loaded.items()}
    return [array(v, ctx=ctx) for v in loaded]
