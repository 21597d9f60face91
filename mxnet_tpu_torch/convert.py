"""Carry weights from the JAX package's Gluon blocks into the port.

``load_mxnet_params(module, named_arrays)`` takes the JAX block's
``{name: p.data().asnumpy() for name, p in block.collect_params().items()}``
and fills the matching port module.  Gluon names are auto-numbered
(``transformerlm0_block1_causalselfattention0_dense0_weight``); the model's
own prefix is stripped and the rest is mapped by structure onto the port's
parameter names (``blocks.1.attn.qkv.weight``).  A missing, extra or
wrongly shaped array raises, naming it.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .base import MXNetError
from .models.transformer_lm import TransformerLM

__all__ = ["load_mxnet_params", "mxnet_to_torch_name"]

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


def load_mxnet_params(module, named_arrays):
    """Copy ``named_arrays`` (Gluon name -> numpy array) into ``module``'s
    parameters, on the parameters' own device and dtype.  Every parameter
    must be filled exactly once, with the same shape."""
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
            params[target].copy_(torch.tensor(named_arrays[name]))
    return module
