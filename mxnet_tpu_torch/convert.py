"""Carry weights from the JAX package's Gluon blocks into the port.

``load_mxnet_params(module, named_arrays)`` takes the JAX block's
``{name: p.data().asnumpy() for name, p in block.collect_params().items()}``
and fills the port module built the same way.  Both packages name a
model's parameters alike after the model's own prefix, which numbers the
models a process built (``resnetv10_stage1_conv2d0_weight`` in one,
``resnetv11_stage1_conv2d0_weight`` in the other), so arrays pair by that
rest of the name (:func:`mxnet_pairs`).  Where the names cannot agree (a
block built otherwise than the JAX one), they pair by position in
construction order instead, each pair's kind (weight, bias, gamma, beta,
running_mean, running_var) and shape checked.  A parameter whose shape
waits for its first call takes it from the array.

A missing, extra or wrongly shaped array raises, naming it.  Arrays arrive
bit for bit, bfloat16 ones (``ml_dtypes``' type, which the JAX package's
``asnumpy()`` gives for a cast block) included, and are copied into the
port's tensors in their dtype.

``ndarrays_from_numpy(named_arrays, ctx)`` makes the same arrays the port's
NDArrays instead, for code written in ``mx.nd``.
"""
from __future__ import annotations

import re

import numpy as np

from .base import MXNetError, tensor_from_numpy
from .context import resolve_device
from .ndarray.ndarray import NDArray, torch_dtype

__all__ = ["load_mxnet_params", "mxnet_to_torch_name", "mxnet_pairs",
           "ndarrays_from_numpy"]

_KINDS = ("running_mean", "running_var", "weight", "bias", "gamma", "beta")


def _local(module, name):
    """``name`` without the automatic prefix of a model of ``module``'s
    kind (its hint and any number: ``resnetv10_``, ``resnetv13_``)."""
    hint = re.escape(module._alias())
    m = re.match(r"^%s\d+_" % hint, name)
    return name if m is None else name[m.end():]


def _port_params(module):
    """``{name after the model's prefix: (structural name, Parameter)}``
    in construction order."""
    n = len(module.prefix)
    return {p.name[n:]: (key, p) for key, p in
            module._collect_params_with_prefix().items()}


def mxnet_to_torch_name(module, name):
    """The port's structural name (``blocks.1.attn.qkv.weight``) for the
    JAX parameter ``name``, or None when ``module`` has no parameter of
    that name."""
    hit = _port_params(module).get(_local(module, name))
    return None if hit is None else hit[0]


def _kind(name):
    return next((k for k in _KINDS if name.endswith(k)), None)


def mxnet_pairs(module, named_arrays):
    """``{JAX name: port structural name}``: by name, or by position where
    no name agrees (see the module docstring).  Raises, naming both sides,
    on an array that is missing, extra or misshaped."""
    ours = _port_params(module)
    names = list(named_arrays)
    local = {n: _local(module, n) for n in names}
    model = type(module).__name__
    if set(local.values()) & set(ours):
        extra = [n for n in names if local[n] not in ours]
        if extra:
            raise MXNetError("extra array %r: no parameter of %s matches it"
                             % (extra[0], model))
        missing = [n for n in ours if n not in set(local.values())]
        if missing:
            raise MXNetError("missing arrays %s (for parameters %s of %s)"
                             % (missing, [ours[n][0] for n in missing],
                                model))
        pairs = [(n, ours[local[n]]) for n in names]
    else:
        if len(names) != len(ours):
            raise MXNetError("%d arrays for the %d parameters of %s, and no "
                             "name agrees" % (len(names), len(ours), model))
        pairs = list(zip(names, ours.values()))
    for i, (name, (key, p)) in enumerate(pairs):
        shape = tuple(np.shape(named_arrays[name]))
        want = p.shape
        fits = len(shape) == len(want) and all(
            w in (0, s) for s, w in zip(shape, want))
        if _kind(name) != _kind(key) or not fits:
            raise MXNetError(
                "array %d, %r with shape %s, does not pair with %r, which "
                "needs %s" % (i, local[name], shape, key, want))
    return {name: key for name, (key, _) in pairs}


def load_mxnet_params(module, named_arrays):
    """Copy ``named_arrays`` (JAX name -> numpy array) into ``module``'s
    parameters (BatchNorm's running statistics included), on their device
    and in their dtype.  Every one must be filled exactly once.  Returns
    ``module``."""
    params = module._collect_params_with_prefix()
    for name, key in mxnet_pairs(module, named_arrays).items():
        params[key]._load_init(tensor_from_numpy(named_arrays[name]))
    return module


def ndarrays_from_numpy(named_arrays, ctx=None):
    """``{name: NDArray}`` holding ``named_arrays``' numpy arrays (the JAX
    package's ``p.data().asnumpy()``) bit for bit, in their dtype (bf16
    included), on ``ctx`` (default ``cuda:0``)."""
    device = resolve_device(ctx)
    out = {}
    for name, a in named_arrays.items():
        t = tensor_from_numpy(a)
        out[name] = NDArray(t.to(device, torch_dtype(t.dtype)))
    return out
