"""Carry weights from the JAX package's Gluon blocks into the port.

``load_mxnet_params(module, named_arrays)`` takes the JAX block's
``{name: p.data().asnumpy() for name, p in block.collect_params().items()}``
and fills the matching port module.  Gluon names are auto-numbered.

- TransformerLM (``transformerlm0_block1_causalselfattention0_dense0_weight``):
  the model's own prefix is stripped and the rest is mapped by structure
  onto the port's parameter names (``blocks.1.attn.qkv.weight``).
- ResNet v1/v2: names are numbered per process and per stage
  (``resnetv10_stage1_conv2d0_bias``), which no fixed rule follows.  The
  port's modules list their arrays in ``state_dict()`` (parameters and
  BatchNorm buffers) in the order Gluon builds them, so the two are paired
  by position (:func:`mxnet_pairs`), each pair's kind (weight, bias, gamma,
  beta, running_mean, running_var) and shape checked.

A missing, extra or wrongly shaped array raises, naming it.  Arrays arrive
bit for bit, bfloat16 ones (``ml_dtypes``' type, which the JAX package's
``asnumpy()`` gives for a cast block) included, and are copied into the
port's tensors in their dtype: into a bf16 model exactly, into an fp32
one widened exactly.

``ndarrays_from_numpy(named_arrays, ctx)`` makes the same arrays the port's
NDArrays instead, for code written in ``mx.nd``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError, tensor_from_numpy
from .context import resolve_device
from .gluon.model_zoo.vision.resnet import ResNetV1, ResNetV2
from .models.transformer_lm import TransformerLM
from .ndarray.ndarray import NDArray, torch_dtype

__all__ = ["load_mxnet_params", "mxnet_to_torch_name", "mxnet_pairs",
           "ndarrays_from_numpy"]

# Gluon name (model prefix stripped) <-> port parameter name, per model.
# ``{i}`` is a layer index, ``{p}`` a parameter kind (weight, bias, ...).
_RULES = {
    TransformerLM: [
        ("embedding0_weight", "tok.weight"),
        ("embedding1_weight", "pos.weight"),
        ("block{i}_layernorm0_{p}", "blocks.{i}.ln1.{p}"),
        ("block{i}_layernorm1_{p}", "blocks.{i}.ln2.{p}"),
        ("block{i}_causalselfattention0_dense0_{p}",
         "blocks.{i}.attn.qkv.{p}"),
        ("block{i}_causalselfattention0_dense1_{p}",
         "blocks.{i}.attn.out.{p}"),
        ("block{i}_dense0_{p}", "blocks.{i}.mlp.0.{p}"),
        ("block{i}_dense1_{p}", "blocks.{i}.mlp.1.{p}"),
        ("layernorm0_{p}", "ln_f.{p}"),
        ("dense0_{p}", "head.{p}"),
    ],
}
_PREFIX = {TransformerLM: re.compile(r"^transformerlm\d+_")}
# models paired by position, and their Gluon prefix
_IN_ORDER = {ResNetV1: re.compile(r"^resnetv1\d+_"),
             ResNetV2: re.compile(r"^resnetv2\d+_")}
_KINDS = ("running_mean", "running_var", "weight", "bias", "gamma", "beta")


def _pattern(template):
    return re.compile(re.escape(template)
                      .replace(r"\{i\}", r"(?P<i>\d+)")
                      .replace(r"\{p\}", r"(?P<p>[a-z]+)"))


def _translate(model, name, src, dst):
    """Map ``name`` through the first matching rule, from the template at
    index ``src`` of each rule to the one at ``dst``; None if none match."""
    for rule in _RULES[model]:
        hit = _pattern(rule[src]).fullmatch(name)
        if hit is not None:
            return rule[dst].format(**hit.groupdict())
    return None


def _rules_for(module):
    model = type(module)
    if model not in _RULES:
        raise MXNetError("no weight map for %s; known: %s"
                         % (model.__name__,
                            sorted(m.__name__ for m in _RULES)))
    return model


def mxnet_to_torch_name(module, name):
    """The port parameter name for the Gluon parameter ``name``, or None
    when no rule of ``module``'s model matches it."""
    model = _rules_for(module)
    m = _PREFIX[model].match(name)
    return None if m is None else _translate(model, name[m.end():], 0, 1)


def _kind(name):
    return next((k for k in _KINDS if name.endswith(k)), None)


def mxnet_pairs(module, named_arrays):
    """``{Gluon name: port state_dict key}`` for a model paired by position
    (ResNet v1/v2): the i-th of ``named_arrays`` (in ``collect_params()``
    order) with the i-th entry of ``module.state_dict()``.  Raises, naming
    both sides, where a pair's kinds or shapes differ or one side runs
    out."""
    prefix = _IN_ORDER.get(type(module))
    if prefix is None:
        raise MXNetError("%s is not paired by position; known: %s"
                         % (type(module).__name__,
                            sorted(m.__name__ for m in _IN_ORDER)))
    targets = module.state_dict(keep_vars=True)
    names, keys = list(named_arrays), list(targets)

    def short(name):   # the Gluon name without the model's prefix
        m = prefix.match(name)
        return name if m is None else name[m.end():]

    for i, (name, key) in enumerate(zip(names, keys)):
        shape = tuple(np.shape(named_arrays[name]))
        want = tuple(targets[key].shape)
        if _kind(name) != key.rsplit(".", 1)[-1] or shape != want:
            raise MXNetError(
                "array %d, %r with shape %s, does not pair with %r, which "
                "needs %s: an array is missing, extra or misshaped near "
                "here" % (i, short(name), shape, key, want))
    if len(names) > len(keys):
        raise MXNetError("extra arrays %s: %s has no entry left for them"
                         % ([short(n) for n in names[len(keys):]],
                            type(module).__name__))
    if len(keys) > len(names):
        raise MXNetError("missing arrays for %s of %s"
                         % (keys[len(names):], type(module).__name__))
    return dict(zip(names, keys))


def load_mxnet_params(module, named_arrays):
    """Copy ``named_arrays`` (Gluon name -> numpy array) into ``module``'s
    parameters (and a ResNet's BatchNorm buffers), on their own device and
    dtype.  Every one must be filled exactly once, with the same shape."""
    if type(module) in _IN_ORDER:
        targets = module.state_dict(keep_vars=True)
        with torch.no_grad():
            for name, key in mxnet_pairs(module, named_arrays).items():
                targets[key].copy_(tensor_from_numpy(named_arrays[name]))
        return module
    params = dict(module.named_parameters())
    filled = {}
    for name, array in named_arrays.items():
        target = mxnet_to_torch_name(module, name)
        if target is None or target not in params:
            raise MXNetError("extra array %r: no parameter of %s matches it"
                             % (name, type(module).__name__))
        if target in filled:
            raise MXNetError("arrays %r and %r both map to parameter %r"
                             % (filled[target], name, target))
        array = np.asarray(array)
        if tuple(array.shape) != tuple(params[target].shape):
            raise MXNetError("array %r has shape %s, parameter %r needs %s"
                             % (name, tuple(array.shape), target,
                                tuple(params[target].shape)))
        filled[target] = name
    missing = sorted(set(params) - set(filled))
    if missing:
        model = _rules_for(module)
        raise MXNetError("missing arrays %s (for parameters %s of %s)"
                         % ([_translate(model, t, 1, 0) for t in missing],
                            missing, model.__name__))
    with torch.no_grad():
        for target, name in filled.items():
            params[target].copy_(tensor_from_numpy(named_arrays[name]))
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
