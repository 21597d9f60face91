"""Post-training int8 quantization (counterpart of
``mxnet_tpu/contrib/quantization.py``): ``quantize``/``dequantize`` of an
NDArray, the calibration thresholds (minmax, and the KL/entropy search of
``_collect_thresholds``), the offline int8 weights (``_quantize_params``)
and ``quantize_model``, the graph rewrite of every FullyConnected and
Convolution node whose weights are known into its
``_contrib_quantized_*`` form behind a ``_contrib_quantize_v2`` of its
data.

The threshold and weight arithmetic is the JAX package's numpy, so that
given the same activations the thresholds and the int8 weights are
bit-equal to its.  The calibration forward runs on the current context.
As in the JAX package, ``simple_bind`` allocates the ``*_quantized``
variables as float32 arrays (shape inference reads no ``__dtype__``), and
each quantized op converts them to int8 as it runs.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..ndarray import NDArray, array

__all__ = ["quantize", "dequantize", "quantize_model"]


def _float(v):
    return float(v.asscalar() if isinstance(v, NDArray) else v)


def quantize(data, min_range, max_range, out_type="uint8"):
    """(codes, [min], [max]): ``data`` as uint8 codes over [min, max], or
    as int8 codes in [-127, 127] over max(|min|, |max|)."""
    from ..ndarray.ndarray import cast
    mn, mx = _float(min_range), _float(max_range)
    x = data._data
    if out_type == "uint8":
        scale = 255.0 / max(mx - mn, 1e-12)
        q = cast(torch.clamp(torch.round((x - mn) * scale), 0, 255),
                 torch.uint8)
    elif out_type == "int8":
        scale = 127.0 / max(abs(mn), abs(mx), 1e-12)
        q = cast(torch.clamp(torch.round(x * scale), -127, 127), torch.int8)
    else:
        raise ValueError(out_type)
    return (NDArray(q), array([mn], ctx=data.context),
            array([mx], ctx=data.context))


def dequantize(data, min_range, max_range, out_type="float32"):
    mn, mx = _float(min_range), _float(max_range)
    x = data._data
    if x.dtype == torch.uint8:
        return NDArray(x.to(torch.float32) * ((mx - mn) / 255.0) + mn)
    return NDArray(x.to(torch.float32) * (max(abs(mn), abs(mx)) / 127.0))


def _smooth_distribution(p, eps=1e-4):
    """Replace zero bins with eps mass taken off the non-zero bins."""
    is_zeros = (p == 0).astype(_np.float64)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    if eps1 >= 1.0:
        return None
    return p + eps * is_zeros - eps1 * (1.0 - is_zeros)


def _collect_thresholds(arr, mode="minmax", num_bins=2001,
                        num_quantized=255, stride=4):
    """Calibration range of a tensor: its extrema (``minmax``), or the
    clip window of least KL divergence between the signed histogram and
    its int8 quantization (``entropy``; one-sided (0, t) for a
    non-negative tensor), searched every ``stride`` bins over 2001."""
    a = arr.asnumpy() if isinstance(arr, NDArray) else _np.asarray(arr)
    if mode == "minmax":
        return float(a.min()), float(a.max())
    a = a.ravel()
    min_val = float(a.min())
    max_val = float(a.max())
    th = max(abs(min_val), abs(max_val))
    if th == 0.0:
        return 0.0, 0.0
    hist, edges = _np.histogram(a, bins=num_bins, range=(-th, th))
    zero = num_bins // 2
    best_t, best_kl = th, _np.inf
    for i in range(num_quantized // 2, num_bins // 2 + 1, stride):
        lo, hi = zero - i, zero + i + 1
        sliced = hist[lo:hi].astype(_np.float64)
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        nonzero = (sliced != 0)
        # merge the window into num_quantized levels, then spread each
        # level's mass evenly over its nonzero source bins
        merged = p.size // num_quantized
        q = _np.zeros(p.size)
        body = sliced[:num_quantized * merged].reshape(num_quantized, merged)
        sums = body.sum(axis=1)
        sums[-1] += sliced[num_quantized * merged:].sum()
        counts = nonzero[:num_quantized * merged].reshape(
            num_quantized, merged).sum(axis=1)
        counts[-1] += nonzero[num_quantized * merged:].sum()
        with _np.errstate(divide="ignore", invalid="ignore"):
            fill = _np.where(counts > 0, sums / _np.maximum(counts, 1), 0.0)
        q[:num_quantized * merged] = _np.repeat(fill, merged)
        # the last level spans to the end of the window
        q[(num_quantized - 1) * merged:] = fill[-1]
        q[~nonzero] = 0.0
        p = _smooth_distribution(p)
        q = _smooth_distribution(q)
        if p is None or q is None:
            continue
        p_n = p / p.sum()
        q_n = q / q.sum()
        kl = float(_np.sum(p_n * _np.log(p_n / q_n)))
        if kl < best_kl:
            best_kl, best_t = kl, float(edges[hi])
    if min_val >= 0:
        return 0.0, best_t
    return -best_t, best_t


_QUANTIZABLE = {"FullyConnected": "_contrib_quantized_fully_connected",
                "Convolution": "_contrib_quantized_conv"}


def _quantize_params(arg_params, weight_names, still_needed=()):
    """The int8 weights and biases: ``name_quantized`` (int8) with
    ``name_min``/``name_max``, on each weight's device; the float original
    stays only where an unquantized node still reads it."""
    qargs = dict(arg_params)
    for name in sorted(set(weight_names)):
        src = arg_params[name]
        ctx = src.context if isinstance(src, NDArray) else None
        arr = src.asnumpy()
        amax = float(max(abs(arr.min()), abs(arr.max()), 1e-12))
        q = _np.clip(_np.round(arr * (127.0 / amax)), -127, 127)
        qargs[name + "_quantized"] = array(q.astype(_np.int8), ctx=ctx)
        qargs[name + "_min"] = array([-amax], ctx=ctx)
        qargs[name + "_max"] = array([amax], ctx=ctx)
        if name not in still_needed:
            del qargs[name]
    return qargs


def _calibrate_ranges(sym, arg_params, aux_params, calib_data, target_inputs,
                      calib_mode, num_calib_examples=None):
    """Run the float graph over the calibration batches, recording the
    range of every tensor that feeds a quantized node (a reservoir of at
    most 2^20 values a node for the entropy search)."""
    from .. import symbol as sym_mod
    probes = sym_mod.Group([s for _, s in target_inputs])
    shapes = {d.name: tuple(d.shape) for d in calib_data.provide_data}
    exe = probes.simple_bind(ctx=None, grad_req="null", **shapes)
    for name, arr in exe.arg_dict.items():
        if name in arg_params:
            arr[:] = arg_params[name]
    for name, arr in exe.aux_dict.items():
        if name in aux_params:
            arr[:] = aux_params[name]
    mode = "minmax" if calib_mode in ("naive", "minmax") else "entropy"
    ranges = {key: (_np.inf, -_np.inf) for key, _ in target_inputs}
    cap = 1 << 20
    samples = {key: [] for key, _ in target_inputs}
    sizes = {key: 0 for key, _ in target_inputs}
    rng = _np.random.RandomState(0)
    seen = 0
    calib_data.reset()
    for batch in calib_data:
        for desc, value in zip(calib_data.provide_data, batch.data):
            if desc.name in exe.arg_dict:
                exe.arg_dict[desc.name][:] = value
        outs = exe.forward(is_train=False)
        for (key, _), out in zip(target_inputs, outs):
            a = out.asnumpy().ravel()
            lo, hi = ranges[key]
            ranges[key] = (min(lo, float(a.min())), max(hi, float(a.max())))
            if mode == "entropy" and sizes[key] < cap:
                if sizes[key] + a.size > cap and a.size > cap // 8:
                    a = rng.choice(a, size=cap // 8, replace=False)
                samples[key].append(a)
                sizes[key] += a.size
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    if mode == "minmax":
        return ranges
    return {key: _collect_thresholds(_np.concatenate(samples[key]), "entropy")
            for key, _ in target_inputs}


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=None, calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8", **kwargs):
    """Rewrite the FullyConnected and Convolution nodes (but those named in
    ``excluded_sym_names``, and those whose weights are not variables in
    ``arg_params``) into their int8 forms.  Weights and biases become
    ``*_quantized`` int8 params with ``*_min``/``*_max``; each node's data
    goes through ``_contrib_quantize_v2``, over its own range under
    ``calib_mode='none'`` or over thresholds calibrated on ``calib_data``
    (``naive``/``minmax``, or ``entropy``).  Returns (quantized symbol,
    quantized arg_params, aux_params)."""
    from ..symbol.symbol import _Node, Symbol
    if quantized_dtype != "int8":
        raise ValueError("quantized_dtype %r is not supported; int8 is the "
                         "quantization the JAX package defines"
                         % (quantized_dtype,))
    if calib_mode != "none" and calib_data is None:
        raise ValueError("calib_mode %r requires calib_data" % (calib_mode,))
    excluded = set(excluded_sym_names or [])
    nodes = sym._topo_nodes()

    def _quantizable(node):
        if node.op not in _QUANTIZABLE or node.name in excluded:
            return False
        n_param = 2 if node.attrs.get("no_bias", False) else 3
        for inp, _idx in node.inputs[1:n_param]:
            if inp.op is not None or inp.name not in arg_params:
                return False
        return True

    thresholds = {}
    if calib_mode != "none" and calib_data is not None:
        target_inputs = []
        for node in nodes:
            if _quantizable(node):
                inp, idx = node.inputs[0]
                target_inputs.append((node.name, Symbol([(inp, idx)])))
        if target_inputs:
            thresholds = _calibrate_ranges(sym, arg_params, aux_params,
                                           calib_data, target_inputs,
                                           calib_mode, num_calib_examples)

    mapping = {}          # id(old node) -> {output idx: (new node, idx)}
    weight_names = []
    qvar_cache = {}       # a shared weight quantizes to one variable triple

    def new_entry(old_node, idx):
        return mapping[id(old_node)][idx]

    for node in nodes:
        if node.op is None:
            mapping[id(node)] = {0: (node, 0)}
            continue
        ins = [new_entry(inp, idx) for inp, idx in node.inputs]
        if _quantizable(node):
            no_bias = bool(node.attrs.get("no_bias", False))
            q_attrs = {"out_type": "int8"}
            if node.name in thresholds:
                mn, mx = thresholds[node.name]
                q_attrs["min_calib_range"] = float(mn)
                q_attrs["max_calib_range"] = float(mx)
            qdata = _Node("_contrib_quantize_v2", node.name + "_quantize",
                          q_attrs, [ins[0]])

            def qvar(pos):
                var = node.inputs[pos][0]
                if var.name in qvar_cache:
                    return qvar_cache[var.name]
                weight_names.append(var.name)
                attrs = dict(var.attrs)
                if var.name in arg_params:
                    attrs["__shape__"] = tuple(arg_params[var.name].shape)
                    attrs["__dtype__"] = "int8"
                qw = _Node(None, var.name + "_quantized", attrs, [])
                wmin = _Node(None, var.name + "_min", {"__shape__": (1,)}, [])
                wmax = _Node(None, var.name + "_max", {"__shape__": (1,)}, [])
                qvar_cache[var.name] = (qw, 0), (wmin, 0), (wmax, 0)
                return qvar_cache[var.name]
            (qw, wmin, wmax) = qvar(1)
            inputs = [(qdata, 0), qw]
            if not no_bias:
                (qb, bmin, bmax) = qvar(2)
                inputs += [qb]
            inputs += [(qdata, 1), (qdata, 2), wmin, wmax]
            if not no_bias:
                inputs += [bmin, bmax]
            qnode = _Node(_QUANTIZABLE[node.op], node.name + "_quantized",
                          dict(node.attrs), inputs)
            mapping[id(node)] = {0: (qnode, 0), 1: (qnode, 1), 2: (qnode, 2)}
        else:
            clone = _Node(node.op, node.name, dict(node.attrs), ins)
            mapping[id(node)] = {i: (clone, i)
                                 for i in range(node.num_outputs)}

    qsym = Symbol([new_entry(n, i) for n, i in sym._entries])
    qargs = _quantize_params(arg_params, weight_names,
                             still_needed=set(qsym.list_arguments()))
    return qsym, qargs, dict(aux_params)
