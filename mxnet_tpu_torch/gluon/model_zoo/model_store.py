"""Load ``.params`` checkpoints into model-zoo blocks (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``: ``map_reference_params``,
``load_pretrained`` and ``_file_is_canonical``, :38-181).

The zoo takes ``pretrained=<path>``, a local ``.params`` file, and never
downloads (``pretrained=True`` raises, as in the JAX package):

- ``save_parameters`` files (structural names, ``features.0.weight``)
  load by name;
- ``collect_params().save`` and model-store files (block-prefixed names,
  ``resnetv10_batchnorm0_gamma``) and Module checkpoints (``arg:``/``aux:``
  prefixes) are paired by kind (weight, bias, gamma, beta, running_mean,
  running_var) in construction order, with their shapes checked: exact,
  since the zoo's blocks are built child for child as the reference's.

A channel-last model takes canonical NCHW convolution weights permuted
into its stored layout; whether a file holds canonical or stored weights is
decided once per file (``_file_is_canonical``).
"""
from __future__ import annotations

import warnings

from ...ndarray import utils

__all__ = ["map_reference_params", "load_pretrained"]

# parameter-name suffixes -> kinds (BatchNorm's moving_* is the
# pre-Gluon spelling); the longest suffix wins
_KIND_ALIASES = [
    ("moving_mean", "running_mean"),
    ("moving_var", "running_var"),
    ("running_mean", "running_mean"),
    ("running_var", "running_var"),
    ("weight", "weight"),
    ("gamma", "gamma"),
    ("bias", "bias"),
    ("beta", "beta"),
]


def _kind(name):
    for suffix, canon in _KIND_ALIASES:
        if name.endswith(suffix):
            return canon
    return None


def map_reference_params(loaded, params):
    """``{structural name: array}`` for a checkpoint ``loaded`` (name ->
    array, any of the naming schemes above) and a block's
    ``_collect_params_with_prefix()`` ``params`` (in construction order).
    Raises, naming both sides, on a count or shape that does not pair."""
    stripped = {}
    for name, arr in loaded.items():
        if name.startswith(("arg:", "aux:")):
            name = name[4:]
        stripped[name] = arr
    if set(stripped) >= set(params):
        return {name: stripped[name] for name in params}

    by_kind_src = {}
    for name, arr in stripped.items():
        kind = _kind(name)
        if kind is None:
            raise ValueError(
                "cannot map checkpoint key %r: unrecognized parameter kind "
                "(expected a weight/bias/gamma/beta/running-stat suffix)"
                % name)
        by_kind_src.setdefault(kind, []).append((name, arr))
    by_kind_dst = {}
    for name in params:
        kind = _kind(name)
        if kind is None:
            raise ValueError("cannot map onto parameter %r: unrecognized "
                             "kind suffix" % name)
        by_kind_dst.setdefault(kind, []).append(name)

    mapped = {}
    ambiguous_kinds = []
    for kind, dst_names in by_kind_dst.items():
        src = by_kind_src.get(kind, [])
        if len(src) != len(dst_names):
            raise ValueError(
                "checkpoint/model mismatch for kind %r: file has %d, model "
                "needs %d (is this checkpoint for a different architecture?)"
                % (kind, len(src), len(dst_names)))
        shapes = [tuple(arr.shape) for _, arr in src]
        if len(set(shapes)) < len(shapes):
            ambiguous_kinds.append(kind)
        for dst, (src_name, arr) in zip(dst_names, src):
            p = params[dst]
            if p.shape and not any(s == 0 for s in p.shape):
                pshape, ashape = tuple(p.shape), tuple(arr.shape)
                perm = p.init_perm
                if pshape != ashape and not (
                        perm is not None and
                        tuple(ashape[j] for j in perm) == pshape):
                    raise ValueError(
                        "shape mismatch mapping %r -> %r: %s vs %s (in-order "
                        "kind pairing failed; architectures differ?)"
                        % (src_name, dst, ashape, pshape))
            mapped[dst] = arr
    extra = set(by_kind_src) - set(by_kind_dst)
    if extra:
        raise ValueError("checkpoint has parameter kinds %s the model lacks"
                         % sorted(extra))
    if ambiguous_kinds:
        warnings.warn(
            "checkpoint has repeated shapes within kinds %s; structural "
            "name-mapping pairs them in file order, which is exact only if "
            "the file preserves construction order: verify outputs, or use "
            "save_parameters (dotted names) for exact matching"
            % ambiguous_kinds, stacklevel=3)
    return mapped


def load_pretrained(net, pretrained, ctx=None):
    """The ``pretrained=`` hook of the model zoo: load the ``.params`` file
    at ``pretrained`` into ``net`` (onto ``ctx``, default the device it was
    built on).  ``pretrained=True`` raises: nothing is downloaded."""
    if pretrained is True:
        raise NotImplementedError(
            "pretrained=True needs the reference model-store download, and "
            "this build does not download: stage the .params file and pass "
            "pretrained='/path/to/file.params' instead")
    loaded = utils.load_numpy(str(pretrained))
    params = net._collect_params_with_prefix()
    mapped = map_reference_params(loaded, params)
    canonical = _file_is_canonical(pretrained, params, mapped)
    for name, arr in mapped.items():
        params[name]._load_init(arr, ctx, prefer_canonical=canonical)


def _file_is_canonical(pretrained, params, mapped):
    """Whether the file's convolution weights are canonical (NCHW, as every
    reference checkpoint) or already in this model's stored layout (a
    channel-last model's ``save_parameters``), decided once per file: a
    kernel whose spatial size equals its input channels fits both ways, and
    the unambiguous kernels elsewhere in the file settle it."""
    canonical_only = stored_only = None
    for name, arr in mapped.items():
        p = params[name]
        perm = p.init_perm
        if perm is None or not p.shape:
            continue
        pshape, ashape = tuple(p.shape), tuple(arr.shape)

        def _fits(shape):
            return (len(shape) == len(pshape) and
                    all(s in (0, d) for s, d in zip(pshape, shape)))
        direct = _fits(ashape)
        permuted = _fits(tuple(ashape[j] for j in perm))
        if permuted and not direct:
            canonical_only = name
        elif direct and not permuted:
            stored_only = name
    if canonical_only and stored_only:
        raise ValueError(
            "checkpoint %s mixes layouts: %r only fits as canonical NCHW but "
            "%r only fits as stored channel-last"
            % (pretrained, canonical_only, stored_only))
    return not stored_only
