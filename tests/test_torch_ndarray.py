"""mxnet_tpu_torch.nd against mxnet_tpu.nd on the CPU.

Every registered op of the port, its value and its gradient, against the
JAX package's op of the same name.  The JAX side runs each table of cases
through ``mxnet_tpu.nd.<op>`` inside one ``jax.jit`` and takes their
gradients with one ``jax.vjp`` (the gradient its tape takes op by op), so
that it compiles once per table rather than once per op; the port runs
each case eagerly through ``mxnet_tpu_torch.nd.<op>``, ``autograd.record()``
and ``backward`` with the same seeded head gradients.  Bounds are the JAX
tests': ``assert_almost_equal``'s default rtol 1e-5 / atol 1e-6 for the
elementwise, shape and optimizer ops, tests/test_operator.py's rtol 1e-4 /
atol 1e-5 for the reductions, GEMMs and nn ops, tests/test_pallas.py's for
flash attention.

Then the semantics tests/test_ndarray.py and tests/test_autograd.py pin,
each written once as a function of the package and run with both:
in-place operators, views, mutation after recording, ``grad_req='add'``,
head gradients, ``pause``, training modes, ``autograd.grad``, dtypes from
numpy.  Where the port follows MXNet and the JAX package does not (a
scalar keeps an integer array's dtype; ``out=`` the weight alone writes an
update op's states back), the port is held to MXNet's rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jax_get_op
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.convert import ndarrays_from_numpy
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops.registry import get_op, list_ops

ELEM = dict(rtol=1e-5, atol=1e-6)
NN = dict(rtol=1e-4, atol=1e-5)
FLASH = dict(rtol=0, atol=2e-5)
FLASH_GRAD = dict(rtol=0, atol=1e-3)   # tests/test_pallas.py

_RNG = np.random.RandomState(0)


def _f(*shape, low=-2.0, high=2.0):
    return _RNG.uniform(low, high, shape).astype(np.float32)


def _away(*shape):
    """Values with |x| in [0.2, 2], off the .5 ties of round."""
    x = _RNG.uniform(0.2, 2.0, shape) * _RNG.choice([-1, 1], shape)
    return np.where(np.abs(np.abs(x) % 1 - 0.5) < 0.05, x + 0.1,
                    x).astype(np.float32)


def _i(*shape, high):
    return _RNG.randint(0, high, shape).astype(np.int32)


class Case:
    """``nd.<name>(*inputs, **attrs)``; gradients are taken for the inputs
    at ``grad`` and compared on the first ``n_out`` outputs."""

    def __init__(self, name, inputs, attrs=None, grad=None, n_out=None,
                 training=False, tol=ELEM, grad_tol=None, grad_outs=None):
        self.name, self.inputs, self.attrs = name, inputs, attrs or {}
        self.grad = [i for i, a in enumerate(inputs)
                     if a.dtype == np.float32] if grad is None else grad
        self.n_out, self.training = n_out, training
        self.tol, self.grad_tol = tol, grad_tol or tol
        # outputs that take a head gradient (BatchNorm's statistics carry
        # none in MXNet)
        self.grad_outs = grad_outs

    def __repr__(self):
        return "%s%s" % (self.name, self.attrs or "")


X, P, B_ = _away(3, 4), _f(3, 4, low=0.3, high=2.0), _f(1, 4, low=0.5,
                                                         high=1.5)
UNARY = ["abs", "sign", "round", "ceil", "floor", "square", "exp", "tanh",
         "negative", "sigmoid", "relu", "identity", "BlockGrad",
         "make_loss", "zeros_like", "ones_like"]
BINARY = ["broadcast_add", "broadcast_sub", "broadcast_mul",
          "broadcast_div", "broadcast_mod", "broadcast_power",
          "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
          "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
          "broadcast_greater_equal", "broadcast_lesser",
          "broadcast_lesser_equal", "broadcast_logical_and",
          "broadcast_logical_or", "broadcast_logical_xor", "arctan2",
          "ldexp"]
SCALAR = ["_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
          "_mod_scalar", "_power_scalar", "_maximum_scalar",
          "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
          "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
          "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
          "_logical_or_scalar", "_logical_xor_scalar"]
_CMP = np.round(P * 2) / 2   # ties with the scalar 1.5 and with P


def _elementwise_cases():
    cases = [Case(n, [X]) for n in UNARY]
    cases += [Case(n, [P]) for n in ("sqrt", "log")]
    cases += [Case("Cast", [X], {"dtype": "float16"}, tol=dict(
        rtol=1e-3, atol=1e-3))]
    # comparisons and logical ops on values with ties
    cases += [Case(n, [P, B_]) for n in BINARY[:9] + BINARY[18:]]
    cases += [Case(n, [_CMP, np.round(B_ * 2) / 2]) for n in BINARY[9:18]]
    cases += [Case(n, [P], {"scalar": 1.5}) for n in SCALAR[:9]]
    cases += [Case(n, [_CMP], {"scalar": 1.5}) for n in SCALAR[9:]]
    cases += [Case(n, [P], {"scalar": 1.5, "reverse": True})
              for n in ("_minus_scalar", "_div_scalar", "_power_scalar",
                        "_mod_scalar")]
    return cases


def _tensor_cases():
    x3 = _f(2, 3, 4)
    return [
        Case("Reshape", [x3], {"shape": (0, -1)}),
        Case("Reshape", [x3], {"shape": (-2,)}),
        Case("Reshape", [x3], {"shape": (-3, 4)}),
        Case("Reshape", [x3], {"shape": (2, -4, 3, -1, 4)}),
        Case("Reshape", [x3], {"shape": (-1, 0), "reverse": True}),
        Case("reshape", [x3], {"shape": (4, 0, 2), "reverse": True}),
        Case("Flatten", [x3]), Case("flatten", [x3]),
        Case("transpose", [x3]),
        Case("transpose", [x3], {"axes": (1, 0, 2)}),
        Case("expand_dims", [x3], {"axis": 1}),
        Case("SliceChannel", [_f(2, 6, 2)],
             {"num_outputs": 3, "axis": 1}),
        Case("split", [_f(2, 3, 6)], {"num_outputs": 2, "axis": -1,
                                      "squeeze_axis": False}),
        Case("split", [_f(2, 3, 2)], {"num_outputs": 2, "axis": 2,
                                      "squeeze_axis": True}),
        Case("Concat", [_f(2, 3), _f(2, 2)], {"dim": 1}),
        Case("concat", [_f(2, 3), _f(1, 3)], {"dim": 0}),
        Case("stack", [_f(2, 3), _f(2, 3)], {"axis": 1}),
        Case("Embedding", [_i(2, 5, high=7), _f(7, 4)],
             {"input_dim": 7, "output_dim": 4}),
        Case("one_hot", [_i(2, 3, high=5)], {"depth": 5, "on_value": 2.0,
                                             "off_value": -1.0}),
        Case("dot", [_f(3, 4), _f(4, 5)], tol=NN),
        Case("dot", [_f(4, 3), _f(5, 4)], {"transpose_a": True,
                                           "transpose_b": True}, tol=NN),
        Case("dot", [_f(2, 3, 4), _f(4, 5)], tol=NN),
        Case("dot", [_f(4), _f(4)], tol=NN),
        Case("batch_dot", [_f(2, 3, 4), _f(2, 4, 5)], tol=NN),
        Case("batch_dot", [_f(2, 4, 3), _f(2, 5, 4)],
             {"transpose_a": True, "transpose_b": True}, tol=NN),
        Case("Embedding", [np.array([[1, 2, 3], [6, 0, 4]], np.float32),
                           _f(7, 4)], {"input_dim": 7, "output_dim": 4},
             grad=[1]),
        Case("slice_like", [_f(4, 5, 6), _f(2, 3, 6)], {"axes": (0, 1)},
             grad=[0]),
        Case("slice_like", [_f(4, 5), _f(3, 2)], grad=[0]),
        Case("_zeros", [], {"shape": (2, 3)}),
        Case("_ones", [], {"shape": (4,), "dtype": "int32"}),
        Case("_arange", [], {"start": 2, "stop": 8, "step": 2,
                             "repeat": 2}),
        Case("_arange", [], {"start": 5, "dtype": "int32"}),
    ]


def _reduce_cases():
    x = _f(2, 3, 4, low=0.5, high=1.5)
    xn = x.copy()
    xn[0, 1, 2] = xn[1, 0, 0] = np.nan
    cases = []
    for name in ("sum", "mean", "prod", "max", "min"):
        cases += [Case(name, [x], tol=NN),
                  Case(name, [x], {"axis": (0, 2), "keepdims": True},
                       tol=NN)]
    cases += [Case("mean", [x], {"axis": 1, "exclude": True}, tol=NN),
              Case("prod", [x], {"axis": -1}, tol=NN),
              Case("mean", [np.array([[3, 4, 8], [1, -2, 0]], np.int32)],
                   {"axis": 1}),
              Case("mean", [_i(2, 3, high=9)])]
    cases += [Case(name, [xn], {"axis": 2}, grad=[], tol=NN)
              for name in ("nansum", "nanprod")]
    cases += [Case("sum_axis", [x], {"axis": 0}, tol=NN),
              Case("max_axis", [x], {"axis": 2}, tol=NN),
              Case("min_axis", [x], {"axis": -1}, tol=NN),
              Case("argmax", [x], {"axis": 1}),
              Case("argmax", [x]),
              Case("argmax", [x], {"axis": 2, "keepdims": True}),
              Case("pick", [x, _f(2, 4, low=-1, high=4)], {"axis": 1}),
              Case("pick", [x, _i(2, 3, high=9)],
                   {"axis": -1, "mode": "wrap", "keepdims": True})]
    return cases


def _nn_cases():
    img = _f(2, 3, 7, 7)
    nhwc = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    w = _f(4, 3, 3, 3, low=-0.5, high=0.5)
    bn = [_f(3, low=0.5, high=1.5), _f(3, low=-0.5, high=0.5),
          _f(3, low=-0.5, high=0.5), _f(3, low=0.5, high=1.5)]
    logits = _f(4, 5)
    lab = np.array([0, 4, 2, 1], np.float32)
    ms = _f(2, 3, 4)
    ms_lab = np.array([[0, 2, 1, 2], [1, 1, 0, 2]], np.float32)
    vol = _f(1, 2, 5, 6, 4)
    cases = [
        Case("FullyConnected", [_f(2, 3, 4), _f(5, 12), _f(5)], tol=NN),
        Case("FullyConnected", [_f(2, 3, 4), _f(5, 4), _f(5)],
             {"flatten": False}, tol=NN),
        Case("FullyConnected", [_f(2, 4), _f(5, 4)], {"no_bias": True},
             tol=NN),
        Case("Convolution", [img, w, _f(4)], {"kernel": (3, 3),
                                              "num_filter": 4}, tol=NN),
        Case("Convolution", [img, w], {"kernel": (3, 3), "stride": (2, 2),
                                       "pad": (1, 1), "no_bias": True,
                                       "num_filter": 4}, tol=NN),
        Case("Convolution", [_f(2, 4, 6, 6), _f(4, 2, 3, 3)],
             {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2,
              "no_bias": True}, tol=NN),
        Case("Convolution", [nhwc, np.ascontiguousarray(
            w.transpose(0, 2, 3, 1)), _f(4)],
             {"kernel": (3, 3), "pad": (1, 1), "layout": "NHWC"}, tol=NN),
        Case("Pooling", [img], {"kernel": (2, 2), "stride": (2, 2)},
             tol=NN),
        Case("Pooling", [img], {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "avg",
                                "pooling_convention": "full"}, tol=NN),
        Case("Pooling", [img], {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "avg",
                                "count_include_pad": False}, tol=NN),
        Case("Pooling", [img], {"global_pool": True, "kernel": (1, 1),
                                "pool_type": "avg"}, tol=NN),
        Case("Pooling", [nhwc], {"kernel": (3, 3), "stride": (2, 2),
                                 "layout": "NHWC",
                                 "pooling_convention": "full"}, tol=NN),
        Case("Pooling", [img], {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "pool_type": "sum",
                                "pooling_convention": "full"}, tol=NN),
        Case("Pooling", [img], {"global_pool": True, "kernel": (1, 1),
                                "pool_type": "sum"}, tol=NN),
        Case("Pooling", [_f(2, 3, 9)], {"kernel": (3,), "stride": (2,),
                                        "pad": (1,), "pool_type": "avg"},
             tol=NN),
        Case("Pooling", [_f(2, 3, 8)], {"kernel": (3,), "stride": (2,),
                                        "pool_type": "sum",
                                        "pooling_convention": "same"},
             tol=NN),
        Case("Pooling", [_f(2, 9, 3)], {"kernel": (2,), "stride": (2,),
                                        "layout": "NWC"}, tol=NN),
        Case("Pooling", [vol], {"kernel": (2, 2, 2), "stride": (2, 2, 2)},
             tol=NN),
        Case("Pooling", [vol], {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                                "pad": (1, 1, 1), "pool_type": "avg",
                                "pooling_convention": "full",
                                "count_include_pad": False}, tol=NN),
        Case("BatchNorm", [img] + bn, {"fix_gamma": False}, grad=[0, 1, 2],
             n_out=3, training=True, tol=NN, grad_outs=1),
        Case("BatchNorm", [img] + bn, {"eps": 1e-5}, grad=[0, 2], n_out=3,
             training=True, tol=NN, grad_outs=1),
        Case("BatchNorm", [img] + bn, {"fix_gamma": False},
             grad=[0, 1, 2], n_out=3, tol=NN, grad_outs=1),
        Case("BatchNorm", [nhwc] + bn, {"axis": -1, "fix_gamma": False},
             grad=[0, 1, 2], n_out=3, training=True, tol=NN, grad_outs=1),
        Case("LayerNorm", [_f(2, 3, 6), _f(6), _f(6)], tol=NN),
        Case("LayerNorm", [_f(2, 6, 3), _f(6), _f(6)], {"axis": 1,
                                                        "eps": 1e-3},
             tol=NN),
        Case("softmax", [logits], tol=NN),
        Case("softmax", [ms], {"axis": 1, "temperature": 2.0}, tol=NN),
        Case("log_softmax", [ms], {"axis": 0}, tol=NN),
        Case("SoftmaxOutput", [logits, lab], tol=NN),
        Case("SoftmaxOutput", [logits, lab], {"normalization": "batch",
                                              "grad_scale": 2.0}, tol=NN),
        Case("SoftmaxOutput", [logits, np.array([0, -1, 2, -1],
                                                np.float32)],
             {"use_ignore": True, "normalization": "valid",
              "smooth_alpha": 0.1, "out_grad": True}, tol=NN),
        Case("SoftmaxOutput", [logits, _f(4, 5, low=0, high=1)],
             {"grad_scale": 0.5}, grad=[0], tol=NN),
        Case("SoftmaxOutput", [ms, ms_lab], {"multi_output": True,
                                             "normalization": "valid",
                                             "use_ignore": True,
                                             "ignore_label": 2}, tol=NN),
        Case("SoftmaxOutput", [ms, ms_lab], {"multi_output": True,
                                             "normalization": "batch",
                                             "out_grad": True}, tol=NN),
        Case("SoftmaxOutput", [ms, np.array([[0, 2, 1], [1, 3, 0]],
                                            np.float32)],
             {"preserve_shape": True}, tol=NN),
        Case("Softmax", [ms, np.array([5, 11], np.float32)], tol=NN),
        Case("softmax_cross_entropy", [logits, lab], tol=NN),
        Case("_contrib_flash_attention", [_f(1, 2, 16, 8), _f(1, 2, 16, 8),
                                          _f(1, 2, 16, 8)],
             {"causal": True}, tol=FLASH, grad_tol=FLASH_GRAD),
        Case("_contrib_flash_attention", [_f(1, 1, 8, 16), _f(1, 1, 12, 16),
                                          _f(1, 1, 12, 16)],
             {"scale": 0.3}, tol=FLASH, grad_tol=FLASH_GRAD),
    ]
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        cases.append(Case("Activation", [X], {"act_type": act}, tol=NN))
    cases += [Case("LeakyReLU", [X], {"act_type": "leaky", "slope": 0.1},
                   tol=NN),
              Case("LeakyReLU", [X], tol=NN),
              Case("LeakyReLU", [X], {"act_type": "elu", "slope": 0.7},
                   tol=NN),
              Case("LeakyReLU", [X], {"act_type": "selu"}, tol=NN),
              Case("LeakyReLU", [X], {"act_type": "gelu"}, tol=NN),
              Case("LeakyReLU", [img, _f(3, low=0.1, high=0.5)],
                   {"act_type": "prelu"}, tol=NN)]
    return cases


def _optimizer_cases():
    w, g, s1, s2 = _f(3, 4), _f(3, 4), _f(3, 4), _f(3, 4, low=0, high=1)
    common = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
              "clip_gradient": 0.3}
    return [
        Case("sgd_update", [w, g], common, grad=[]),
        Case("sgd_mom_update", [w, g, s1], dict(common, momentum=0.9),
             grad=[]),
        Case("mp_sgd_update", [w, g, s1], common, grad=[]),
        Case("mp_sgd_mom_update", [w, g, s1, s2],
             dict(common, momentum=0.9), grad=[]),
        Case("adam_update", [w, g, s1, s2], dict(common, lr="0.01",
                                                 beta1=0.8), grad=[]),
    ]


def _layer_op_cases():
    """The ops the Gluon layers, losses and zoo gained (their own draws, so
    the tables above keep their inputs)."""
    rng = np.random.RandomState(7)

    def f(*shape, low=-2.0, high=2.0):
        return rng.uniform(low, high, shape).astype(np.float32)

    img = f(2, 3, 5, 6)
    cond = np.where(rng.uniform(size=(3, 4)) > 0.5, 1.0, 0.0).astype(
        np.float32)
    ctc = f(6, 2, 5)
    return [
        Case("clip", [f(3, 4)], {"a_min": -0.5, "a_max": 1.0}),
        Case("clip", [f(3, 4)], {"a_max": 0.25}),
        Case("Pad", [img], {"mode": "constant", "constant_value": 0.5,
                            "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
        Case("Pad", [img], {"mode": "edge",
                            "pad_width": (0, 0, 0, 0, 2, 1, 0, 3)}),
        Case("pad", [img], {"mode": "reflect",
                            "pad_width": (0, 0, 0, 0, 2, 2, 1, 1)}),
        Case("where", [cond, f(3, 4), f(3, 4)], grad=[1, 2]),
        Case("reshape_like", [f(2, 6), f(3, 4)], grad=[0]),
        Case("InstanceNorm", [img, f(3), f(3)], {"eps": 1e-3}, tol=NN),
        Case("InstanceNorm", [f(2, 4, 7), f(4), f(4)], tol=NN),
        Case("Dropout", [f(3, 4)], {"p": 0.5}),
        Case("CTCLoss", [ctc, np.array([[0, 2, -1], [1, 1, 3]],
                                       np.float32)],
             {"blank_label": "last"}, grad=[0], tol=NN),
        Case("CTCLoss", [ctc, np.array([[1, 2, 0], [3, 3, 1]], np.float32),
                         np.array([6, 4], np.float32),
                         np.array([2, 3], np.float32)],
             {"use_data_lengths": True, "use_label_lengths": True},
             grad=[0], tol=NN),
    ]


TABLES = {"elementwise": _elementwise_cases(), "tensor": _tensor_cases(),
          "reduce": _reduce_cases(), "nn": _nn_cases(),
          "optimizer": _optimizer_cases(), "layer_ops": _layer_op_cases()}


def _outputs(result, case):
    outs = result if isinstance(result, (list, tuple)) else [result]
    return list(outs[:case.n_out])


def _jax_table(cases):
    """Every case's outputs and input gradients through mxnet_tpu.nd, in
    one jitted function and one vjp, with seeded head gradients."""
    flat = [a for c in cases for a in c.inputs]

    def run(*vals):
        it = iter(vals)
        outs = []
        for c in cases:
            arrays = [jmx.nd.NDArray(next(it)) for _ in c.inputs]
            scope = jmx.autograd.train_mode() if c.training \
                else jmx.autograd.predict_mode()
            with scope:
                result = getattr(jmx.nd, c.name)(*arrays, **c.attrs)
            outs.append([o._data for o in _outputs(result, c)])
        return outs

    outs, vjp = jax.vjp(jax.jit(run), *[jnp.asarray(a) for a in flat])
    rng = np.random.RandomState(1)

    def head(o, k, case):
        if not jnp.issubdtype(o.dtype, jnp.floating):
            return np.zeros(o.shape, jax.dtypes.float0)
        if case.grad_outs is not None and k >= case.grad_outs:
            return np.zeros(o.shape, np.float32)
        return rng.normal(0, 1, o.shape).astype(np.float32)

    heads = [[head(o, k, c) for k, o in enumerate(case_outs)]
             for c, case_outs in zip(cases, outs)]
    grads = iter(vjp([[jnp.asarray(h, dtype=o.dtype) if h.dtype != jax.
                       dtypes.float0 else h for h, o in zip(hs, os_)]
                      for hs, os_ in zip(heads, outs)]))
    per_case = []
    for c, case_outs, hs in zip(cases, outs, heads):
        gs = [next(grads) for _ in c.inputs]
        per_case.append(([np.asarray(o) for o in case_outs], hs,
                         [np.asarray(gs[i]) for i in c.grad]))
    return per_case


def _port_case(c, heads):
    """The case through mxnet_tpu_torch.nd on the CPU, its outputs and the
    gradients of its ``grad`` inputs under the head gradients ``heads``.
    It runs in a ``cpu()`` scope, where the creators, which have no input
    to take a device from, make their arrays."""
    nd, autograd = tmx.nd, tmx.autograd
    arrays = [nd.array(a, ctx=tmx.cpu(), dtype=a.dtype) for a in c.inputs]
    for i in c.grad:
        arrays[i].attach_grad()
    with autograd.record(train_mode=c.training), tmx.cpu():
        outs = _outputs(getattr(nd, c.name)(*arrays, **c.attrs), c)
    pairs = [(o, nd.array(h, ctx=tmx.cpu(), dtype=o.dtype))
             for o, h in zip(outs, heads)
             if o._data.requires_grad and h.dtype != jax.dtypes.float0]
    if pairs and c.grad:
        autograd.backward([o for o, _ in pairs], [h for _, h in pairs])
    grads = [arrays[i].grad.asnumpy() for i in c.grad]
    return [o.asnumpy() for o in outs], grads


@pytest.fixture(scope="module")
def jax_reference():
    """Every table's JAX results, from one jit and one vjp."""
    results = iter(_jax_table([c for t in sorted(TABLES)
                               for c in TABLES[t]]))
    return {t: [next(results) for _ in TABLES[t]] for t in sorted(TABLES)}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_ops_match_jax_values_and_gradients(table, jax_reference):
    cases = TABLES[table]
    for c, (want, heads, want_grads) in zip(cases, jax_reference[table]):
        got, got_grads = _port_case(c, heads)
        assert len(got) == len(want), c
        for g, w in zip(got, want):
            assert g.shape == w.shape, (c, g.shape, w.shape)
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=repr(c), **c.tol)
        for g, w in zip(got_grads, want_grads):
            np.testing.assert_allclose(g, w, err_msg="grad " + repr(c),
                                       **c.grad_tol)


def test_registry_names_and_aliases_are_the_jax_packages():
    names = list_ops()
    assert len(names) > 100
    for name in names:
        op = get_op(name)
        jop = jax_get_op(name)
        assert op.n_outputs({"num_outputs": 3}) == jop.n_outputs(
            {"num_outputs": 3}), name
        assert op.visible_outputs == jop.visible_outputs, name
        assert bool(op.mode_dependent) == bool(jop.mode_dependent), name
        assert set(op.dynamic_attrs) == set(jop.dynamic_attrs), name
        assert bool(op.no_grad) == bool(jop.no_grad), name
        for other in names:   # aliases of one op in both, or in neither
            assert (get_op(other) is op) == (jax_get_op(other) is jop), (
                name, other)
    # every op a table holds to the JAX package; the ops that draw are held
    # bit for bit in tests/test_torch_random.py, from one seed in both
    tested = {c.name for cases in TABLES.values() for c in cases}
    draws = {n for n in names if get_op(n).needs_rng and n != "Dropout"
             and n != "LeakyReLU"}
    assert set(names) - tested - draws <= {
        "_copy", "stop_gradient", "cast", "elemwise_add", "elemwise_sub",
        "elemwise_mul", "elemwise_div", "_plus", "_sub", "_mul", "_div",
        "_maximum", "_minimum", "_power", "maximum", "minimum",
        "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"}


def test_attrs_key_is_the_jax_packages():
    from mxnet_tpu.base import attrs_key as jax_attrs_key
    from mxnet_tpu_torch.base import attrs_key
    attrs = {"shape": [0, -1], "axes": (1, 0), "dtype": np.dtype("int32"),
             "w": np.arange(3), "nested": {"b": [1], "a": 2}, "_k": 7}
    assert attrs_key(attrs) == jax_attrs_key(attrs)
    assert attrs_key(attrs, skip="_k") == jax_attrs_key(attrs, skip="_k")
    hash(attrs_key(attrs))


def test_rng_ops_raise_until_the_rng_is_ported():
    """The RNG is ported; the rejection samplers still raise, naming
    themselves, and take their key like every op that draws."""
    for name in ("_random_gamma", "_random_poisson", "_sample_gamma"):
        assert get_op(name).needs_rng
    with pytest.raises(MXNetError, match="_random_gamma"):
        tmx.nd.random.gamma(2.0, 1.0, shape=(3,), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="_random_poisson"):
        tmx.nd.random.poisson(2.0, shape=(3,), ctx=tmx.cpu())


def test_rrelu_draws_and_raises_until_the_rng_is_ported():
    """rrelu draws its slopes from the call's key: bit for bit the JAX
    op's in training for one seed, the midpoint in prediction."""
    x = _f(2, 3)
    for seed in (0, 5):
        tmx.random.seed(seed)
        jmx.random.seed(seed)
        with tmx.autograd.train_mode():
            got = tmx.nd.LeakyReLU(tmx.nd.array(x, ctx=tmx.cpu()),
                                   act_type="rrelu").asnumpy()
        with jmx.autograd.train_mode():
            want = jmx.nd.LeakyReLU(jmx.nd.array(x),
                                    act_type="rrelu").asnumpy()
        np.testing.assert_array_equal(got, want)
    got = tmx.nd.LeakyReLU(tmx.nd.array(x, ctx=tmx.cpu()),
                           act_type="rrelu").asnumpy()
    want = jmx.nd.LeakyReLU(jmx.nd.array(x), act_type="rrelu").asnumpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sum", "mean", "prod", "max", "min"])
def test_exclude_with_a_negative_axis_reduces_as_numpy(name):
    """The port normalises a negative axis before ``exclude`` (as MXNet and
    numpy): held to numpy there, and to the JAX package for non-negative
    axes, where the two packages agree."""
    x = _f(2, 3, 4, low=0.5, high=1.5)
    got = getattr(tmx.nd, name)(tmx.nd.array(x, ctx=tmx.cpu()), axis=-1,
                                exclude=True).asnumpy()
    want = getattr(np, name)(x, axis=(0, 1))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, **NN)
    for axis in (2, (0, 2)):
        got = getattr(tmx.nd, name)(tmx.nd.array(x, ctx=tmx.cpu()),
                                    axis=axis, exclude=True).asnumpy()
        want = getattr(jmx.nd, name)(jmx.nd.array(x), axis=axis,
                                     exclude=True).asnumpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **NN)


def test_flash_attention_op_takes_the_plain_version_on_the_cpu():
    q = tmx.nd.array(_f(1, 2, 16, 8), ctx=tmx.cpu())
    before = cuda_ops.flash_attention.launches
    out = tmx.nd._contrib_flash_attention(q, q, q, causal=True)
    want = cuda_ops._attention_reference(q._data, q._data, q._data, True,
                                         8 ** -0.5)
    assert torch.equal(out._data, want)
    assert cuda_ops.flash_attention.launches == before


# ---------------------------------------------------------------------------
# semantics, written once and run with both packages

def _semantics(mx, ctx):
    nd, autograd = mx.nd, mx.autograd
    r = {}
    x = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=ctx)
    y = nd.array(np.full((2, 3), 2, np.float32), ctx=ctx)
    x += y
    x -= 1
    x *= y
    x /= 2
    r["inplace"] = x
    base = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    row = base[0]
    nested = base[0:2][1]
    base[:] = 5
    r["view_sees_base"], r["nested_view"] = row.asnumpy(), nested.asnumpy()
    row[:] = 7
    base[1:2] = nd.array(np.ones((1, 4), np.float32), ctx=ctx)
    r["write_through"] = base
    x = nd.array([1.0, 2.0], ctx=ctx)
    x.attach_grad()
    with autograd.record():
        y = x * x
    x[:] = 100.0
    y.backward()
    r["mutation_after_record"] = x.grad
    x = nd.array([1.0, -2.0], ctx=ctx)
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            y = nd.exp(x) * 2
        y.backward()
    r["grad_req_add"] = x.grad
    x = nd.array([1.0, 2.0], ctx=ctx)
    x.attach_grad()
    with autograd.record():
        y = x * 2 + x * x
    y.backward(nd.array([10.0, 20.0], ctx=ctx))
    r["head_grad"] = x.grad
    with autograd.record():
        y = x * 2
        with autograd.pause():
            z = y * 2
        w = (y * y).sum()
    w.backward()
    r["pause"], r["paused_value"] = x.grad, z
    a, b = nd.array([2.0], ctx=ctx), nd.array([3.0], ctx=ctx)
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        c = a * a * b + nd.exp(b)
    r["grad_api"] = autograd.grad(c, [a, b])
    with autograd.record():
        c = (a * 2).detach() * a + a
    c.backward()
    r["detach"] = a.grad
    modes = []
    with autograd.record():
        modes.append((autograd.is_recording(), autograd.is_training()))
        with autograd.predict_mode():
            modes.append((autograd.is_recording(), autograd.is_training()))
    with autograd.train_mode():
        modes.append((autograd.is_recording(), autograd.is_training()))
    r["modes"] = modes
    r["dtypes"] = [str(nd.array(np.array([1, 2], np.int64), ctx=ctx).dtype),
                   str(nd.array(np.array([1.5]), ctx=ctx).dtype),
                   str(nd.array([1, 2], ctx=ctx).dtype),
                   str(nd.array(np.array([1], np.int32), ctx=ctx,
                                dtype="float32").dtype),
                   str(nd.ones((2,), ctx=ctx).dtype)]
    r["reduce_all_shape"] = nd.array([[1.0, 2.0]], ctx=ctx).sum().shape
    return r


def _creators(mx, ctx):
    nd = mx.nd
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = nd.array(src, ctx=ctx)
    out = nd.zeros((2, 3), ctx=ctx)
    nd.full((2, 3), 7.0, ctx=ctx, out=out)
    copy = a.copy()
    a[:] = 1.0   # the copies keep their values
    b = nd.zeros((2, 3), ctx=ctx)
    copy.copyto(b)
    return {"zeros": nd.zeros((2, 3), ctx=ctx), "ones": nd.ones(4, ctx=ctx),
            "empty_shape": nd.empty((3, 2), ctx=ctx).shape,
            "full": nd.full((2,), 2.5, ctx=ctx),
            "full_out": out,
            "arange": nd.arange(2, 8, 2, repeat=2, ctx=ctx),
            "arange_int": nd.arange(5, ctx=ctx, dtype="int32"),
            "concat": nd.concat(a, copy, dim=0),
            "stack": nd.stack(a, copy, axis=1),
            "copy": copy, "copyto": b,
            "astype": copy.astype("int32"),
            "array_of_array": nd.array(copy, ctx=ctx, dtype="float16"),
            "scalar": copy[1, 2].asscalar(),
            "advanced_index": copy[nd.array([1, 0], ctx=ctx)]}


def test_creators_and_copies_match_jax():
    want = _creators(jmx, jmx.cpu())
    got = _creators(tmx, tmx.cpu())
    for key, w in want.items():
        g = got[key]
        if isinstance(w, tuple):
            assert g == w, key
            continue
        g, w = _np(g), _np(w)
        assert np.asarray(g).dtype == np.asarray(w).dtype, (key, g, w)
        np.testing.assert_array_equal(g, w, err_msg=key)


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return v.asnumpy() if hasattr(v, "asnumpy") else v


def test_semantics_match_jax():
    want = _semantics(jmx, jmx.cpu())
    got = _semantics(tmx, tmx.cpu())
    assert got.keys() == want.keys()
    for key in want:
        w, g = _np(want[key]), _np(got[key])
        if key in ("modes", "dtypes", "reduce_all_shape"):
            assert g == w, (key, g, w)
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       err_msg=key, **ELEM)


def test_a_scalar_keeps_an_integer_arrays_dtype_as_in_mxnet():
    """MXNet computes a scalar op in the array's dtype.  (The JAX package
    passes the scalar as a Python float and gets float32.)"""
    a = tmx.nd.array(np.array([-3, 5], np.int64), ctx=tmx.cpu())
    assert a.dtype == np.int32
    for out, want in ((a + 1, [-2, 6]), (a * 2, [-6, 10]),
                      (a / 2, [-1, 2]), (a - 1.7, [-4, 4]),
                      (a == 5, [0, 1])):
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out.asnumpy(), want)
    assert (tmx.nd.ones((2,), ctx=tmx.cpu()) + 1).dtype == np.float32


def test_update_ops_write_their_states_back_given_only_the_weight():
    """``out=`` the weight alone writes the new states into the state
    inputs, as MXNet's ops mutate them; ``out=`` all of them writes the
    same values.  (The JAX package's ops write only the weight.)"""
    nd = tmx.nd
    arrays = [_f(3, 4), _f(3, 4), _f(3, 4), _f(3, 4, low=0, high=1)]
    runs = []
    for all_out in (False, True):
        w, g, m, v = (nd.array(a, ctx=tmx.cpu()) for a in arrays)
        out = [w, m, v] if all_out else w
        assert nd.adam_update(w, g, m, v, out=out, lr=0.01) is out
        runs.append([t.asnumpy() for t in (w, m, v)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][1], arrays[2])
    w, g, mom = (nd.array(a, ctx=tmx.cpu()) for a in arrays[:3])
    nd.sgd_mom_update(w, g, mom, out=w, lr=0.1, momentum=0.9)
    np.testing.assert_allclose(mom.asnumpy(),
                               0.9 * arrays[2] - 0.1 * arrays[1], **ELEM)


def test_write_gradients_do_not_accumulate_in_torch():
    """``grad_req='write'``: each backward overwrites ``x.grad``, and the
    leaf tensors torch holds keep no ``.grad`` of their own, also after
    the array's buffer was swapped."""
    nd, autograd = tmx.nd, tmx.autograd
    x = nd.array([1.0, 2.0], ctx=tmx.cpu())
    x.attach_grad()
    leaves = []
    for k in (1.0, 2.0):
        leaves.append(x._data)
        with autograd.record():
            y = x * k
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [k, k])
        x[:] = 5.0
    assert leaves[0] is not leaves[1]
    assert all(t.grad is None for t in leaves + [x._data])


def test_contexts_scope_the_default_device():
    nd = tmx.nd
    with tmx.cpu():
        assert tmx.current_context() == torch.device("cpu")
        assert nd.ones((2, 2)).context == torch.device("cpu")
        with tmx.gpu(0):
            assert tmx.context._scoped_device() == torch.device("cuda", 0)
        assert nd.zeros(3).context == torch.device("cpu")
    assert nd.array([1.0], ctx=tmx.cpu()).context == torch.device("cpu")


def test_out_on_another_device_raises_instead_of_moving():
    nd = tmx.nd
    out = nd.zeros((2,), ctx="meta")
    with pytest.raises(MXNetError, match="out="):
        nd.elemwise_add(nd.ones((2,), ctx=tmx.cpu()),
                        nd.ones((2,), ctx=tmx.cpu()), out=out)


def test_ndarrays_from_numpy_carry_jax_arrays_bit_for_bit():
    """fp32, bf16 (``ml_dtypes``' arrays, which the JAX package's
    ``asnumpy()`` gives) and int32 arrays keep their bits; a bf16 array's
    ``asnumpy()`` is its exact widening to float32."""
    a = _f(3, 4)
    named = {"w": a, "i": np.arange(3, dtype=np.int32),
             "w_bf16": jmx.nd.array(a).astype("bfloat16").asnumpy()}
    got = ndarrays_from_numpy(named, tmx.cpu())
    assert got["w"].dtype == np.float32 and got["i"].dtype == np.int32
    np.testing.assert_array_equal(got["w"].asnumpy(), a)
    np.testing.assert_array_equal(got["i"].asnumpy(), named["i"])
    assert got["w_bf16"].dtype == "bfloat16"
    assert np.array_equal(got["w_bf16"]._data.view(torch.int16).numpy(),
                          named["w_bf16"].view(np.int16))
    widened = got["w_bf16"].asnumpy()
    assert widened.dtype == np.float32
    np.testing.assert_array_equal(widened,
                                  named["w_bf16"].astype(np.float32))
