"""The registry's dense families in mxnet_tpu_torch against mxnet_tpu on
the CPU: every op name the port gained with its int8 slice, values and
gradients, the ``NDArray`` methods over them, ``nd.linalg``,
``nd.moveaxis`` and the ``sym`` namespaces, the saturating ``Cast``, and
the audit of the names still to port.

The harness is tests/test_torch_ndarray.py's: the JAX side of every table
runs in one ``jax.jit`` and one ``jax.vjp`` with seeded head gradients,
the port's eagerly through ``mxnet_tpu_torch.nd`` and ``backward``.
Bounds are the JAX package's own tests': ``assert_almost_equal``'s rtol
1e-5 / atol 1e-6 (ELEM) for the elementwise, shape, index and ordering
ops; tests/test_operator.py's rtol 1e-4 / atol 1e-5 (NN) for the
reductions, products, normalizations and pooling;
tests/test_registry_ops_r6.py's rtol 1e-4 / atol 1e-4 (LINALG) for the
factorizations, solves and inverses and their gradients; and 0 (EXACT)
for the int8 ops' values, which the port holds bit for bit (their
gradients, sums over every output into the float ranges, at NN).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.ops.registry import list_ops as jax_list_ops
from mxnet_tpu_torch.ops.registry import get_op, list_ops
from test_torch_ndarray import Case, _jax_table, _port_case

ELEM = dict(rtol=1e-5, atol=1e-6)
NN = dict(rtol=1e-4, atol=1e-5)
LINALG = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=0, atol=0)

# registered in the JAX package, waiting for a later slice of the port
WAITING = {
    # multi-device BatchNorm
    "_contrib_SyncBatchNorm",
    # with operator.py
    "Custom",
}

# the detection and spatial ops (example/ssd, example/rcnn), held to the
# JAX package in tests/test_torch_detection_ops.py
DETECTION = {
    "ROIPooling", "_contrib_ROIAlign", "_contrib_PSROIPooling",
    "_contrib_DeformablePSROIPooling", "_contrib_DeformableConvolution",
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "_contrib_Proposal",
    "_contrib_MultiProposal", "_contrib_box_iou", "_contrib_box_nms",
    "_contrib_bipartite_matching", "BilinearSampler", "GridGenerator",
    "SpatialTransformer", "Correlation",
}

_RNG = np.random.RandomState(15)


def _f(*shape, low=-2.0, high=2.0):
    return _RNG.uniform(low, high, shape).astype(np.float32)


def _away(*shape, low=0.3, high=2.0):
    """|x| in [low, high], either sign."""
    return (_RNG.uniform(low, high, shape)
            * _RNG.choice([-1, 1], shape)).astype(np.float32)


def _i8(*shape):
    return _RNG.randint(-127, 128, shape).astype(np.int8)


def _spd(n, batch=()):
    a = _RNG.uniform(-1, 1, batch + (n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _lower(n, batch=()):
    """Well-conditioned lower-triangular matrices (diagonal in [1, 2])."""
    a = np.tril(_RNG.uniform(-0.5, 0.5, batch + (n, n)))
    idx = np.arange(n)
    a[..., idx, idx] = _RNG.uniform(1.0, 2.0, batch + (n,))
    return a.astype(np.float32)


def _elementwise_cases():
    x = _f(3, 4)
    unit = _f(3, 4, low=-0.9, high=0.9)
    pos = _f(3, 4, low=0.3, high=2.0)
    ties = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 1.3, -1.7],
                     [0.0, -0.2, 3.49, -3.51]], np.float32)
    gam = np.array([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.3, 4.0, -0.3],
                    [3.7, 0.2, -1.2, 5.5]], np.float32)
    special = np.array([[np.nan, 1.0, -np.inf, 0.0],
                        [np.inf, -2.0, np.nan, 3.0]], np.float32)
    cases = [Case(n, [x]) for n in (
        "sin", "cos", "arctan", "sinh", "cosh", "arcsinh", "degrees",
        "radians", "erf", "expm1", "softsign", "negative")]
    cases += [Case("tan", [_f(3, 4, low=-1.2, high=1.2)])]
    cases += [Case(n, [unit]) for n in ("arcsin", "arccos", "arctanh",
                                        "erfinv")]
    cases += [Case("arccosh", [_f(3, 4, low=1.2, high=3.0)])]
    cases += [Case(n, [pos]) for n in ("log10", "log2", "log1p", "rsqrt",
                                       "reciprocal")]
    cases += [Case(n, [_away(3, 4)]) for n in ("cbrt", "rcbrt")]
    cases += [Case(n, [ties]) for n in ("rint", "fix", "trunc")]
    cases += [Case(n, [gam]) for n in ("gamma", "gammaln")]
    cases += [Case(n, [special], grad=[]) for n in ("isnan", "isinf")]
    cases += [Case("logical_not", [np.round(x)])]
    cases += [Case("hard_sigmoid", [_f(3, 4, low=-4, high=4)]),
              Case("hard_sigmoid", [x], {"alpha": 0.3, "beta": 0.4}),
              Case("smooth_l1", [x]),
              Case("smooth_l1", [x], {"scalar": 2.0}),
              Case("add_n", [x, pos, unit]),
              Case("ElementWiseSum", [x, pos])]
    return cases


def _reduce_cases():
    x = _f(2, 3, 4, low=0.5, high=1.5)
    return [
        Case("_square_sum", [x], {"axis": 1}, tol=NN),
        Case("_square_sum", [x], {"axis": (0, 2), "keepdims": True},
             tol=NN),
        Case("norm", [x], tol=NN),
        Case("norm", [x], {"ord": 1, "axis": (0, 2)}, tol=NN),
        Case("norm", [x], {"axis": -1, "keepdims": True}, tol=NN),
        Case("argmin", [_f(3, 5)], {"axis": 1}),
        Case("argmin", [_f(3, 5)]),
        Case("argmin", [_f(3, 5)], {"axis": 0, "keepdims": True}),
        Case("argmax_channel", [_f(2, 3, 4)]),
    ]


def _tensor_cases():
    x3 = _f(2, 3, 4)
    tie = np.array([[3, 1, 3, 2, 1, 3], [0, 5, 5, 1, 0, 2]], np.float32)
    return [
        Case("SwapAxis", [x3], {"dim1": 0, "dim2": 2}),
        Case("swapaxes", [x3], {"dim1": 1, "dim2": -1}),
        Case("squeeze", [_f(2, 1, 3, 1)]),
        Case("squeeze", [_f(2, 1, 3, 1)], {"axis": 1}),
        Case("squeeze", [_f(2, 1, 3, 1)], {"axis": (1, 3)}),
        Case("shape_array", [x3], grad=[]),
        Case("size_array", [x3], grad=[]),
        Case("broadcast_to", [_f(1, 3, 1)], {"shape": (2, 3, 4)}),
        Case("broadcast_to", [_f(2, 3, 1)], {"shape": (0, 0, 4)}),
        Case("broadcast_like", [_f(1, 4), _f(3, 4)], grad=[0]),
        Case("broadcast_axis", [_f(1, 3, 1)], {"axis": (0, 2),
                                               "size": (2, 4)}),
        Case("broadcast_axes", [_f(1, 3)], {"axis": 0, "size": 3}),
        Case("slice", [x3], {"begin": (0, 1), "end": (2, 3)}),
        Case("slice", [x3], {"begin": (None, 2, 3), "end": (None, 0, None),
                             "step": (1, -1, -2)}),
        Case("crop", [x3], {"begin": (1, None, 1), "end": (2, None, 4)}),
        Case("slice_axis", [x3], {"axis": 1, "begin": 1, "end": None}),
        Case("slice_axis", [x3], {"axis": -1, "begin": -3, "end": -1}),
        Case("reverse", [x3], {"axis": (0, 2)}),
        Case("flip", [x3], {"axis": 1}),
        Case("repeat", [x3], {"repeats": 2, "axis": 1}),
        Case("repeat", [_f(2, 3)], {"repeats": 3}),
        Case("tile", [x3], {"reps": (2, 1, 3)}),
        Case("tile", [_f(2, 3)], {"reps": (2,)}),
        Case("diag", [_f(4)], {"k": 1}),
        Case("diag", [_f(3, 4)], {"k": -1}),
        Case("diag", [x3]),
        Case("take", [_f(4, 3), np.array([[0, 3], [5, -1]], np.float32)]),
        Case("take", [_f(4, 3), np.array([1, 6, -2], np.float32)],
             {"axis": 0, "mode": "wrap"}, grad=[0]),
        Case("take", [x3, np.array([-1, 5, -4, 2], np.float32)],
             {"axis": 2, "mode": "raise"}, grad=[0]),
        Case("batch_take", [_f(4, 5), np.array([-1, 7, 2, 0], np.float32)],
             grad=[0]),
        Case("gather_nd", [_f(3, 4, 2), np.array(
            [[-1, 5, 0, 2, 1], [-2, 1, 9, 0, 3]], np.float32)], grad=[0]),
        Case("scatter_nd", [_f(5), np.array(
            [[-1, 5, 0, 2, 1], [-2, 1, 3, 0, 3]], np.float32)],
             {"shape": (3, 4)}, grad=[0]),
        Case("_scatter_set_nd", [_f(3, 4), np.array(
            [[0, 2, 1], [1, 3, 0]], np.float32), _f(3)], grad=[0, 2]),
        Case("sort", [tie]),
        Case("sort", [tie], {"is_ascend": False, "axis": 0}),
        Case("sort", [x3], {"axis": 1}),
        Case("argsort", [tie], grad=[]),
        Case("argsort", [tie], {"is_ascend": False, "dtype": "int32"},
             grad=[]),
        Case("topk", [tie], {"k": 3}, grad=[]),
        Case("topk", [tie], {"k": 2, "ret_typ": "value", "axis": 0}),
        Case("topk", [tie], {"k": 4, "ret_typ": "both", "is_ascend": True},
             n_out=2),
        Case("topk", [tie], {"k": 2, "ret_typ": "mask"}, grad=[]),
        Case("topk", [x3], {"k": 3, "ret_typ": "value", "axis": 1}),
        Case("khatri_rao", [_f(3, 4), _f(2, 4)]),
        Case("khatri_rao", [_f(2, 3), _f(2, 3), _f(3, 3)]),
        Case("_full", [], {"shape": (2, 3), "value": 2.5}),
        Case("_full", [], {"shape": (4,), "value": -2.7, "dtype": "int32"}),
        Case("_eye", [], {"N": 3, "M": 4, "k": 1}),
        Case("_eye", [], {"N": 3, "dtype": "int32", "k": -1}),
        Case("space_to_depth", [_f(1, 2, 4, 6)], {"block_size": 2}),
        Case("depth_to_space", [_f(1, 8, 2, 3)], {"block_size": 2}),
        Case("ravel_multi_index", [np.array([[1, 2, 0], [3, 0, 2]],
                                            np.float32)],
             {"shape": (3, 4)}, grad=[]),
        Case("_ravel_multi_index", [np.array([[2], [1]], np.float32)],
             {"shape": (3, 4)}, grad=[]),
        Case("unravel_index", [np.array([0, 7, 11, 5], np.float32)],
             {"shape": (3, 4)}, grad=[]),
        Case("_unravel_index", [np.array([13, 2], np.float32)],
             {"shape": (2, 3, 4)}, grad=[]),
    ]


def _linalg_cases():
    A, B, C = _f(2, 3, 4), _f(2, 4, 5), _f(2, 3, 5)
    spd, L = _spd(4, (2,)), _lower(4, (2,))
    sq = _spd(3) + _f(3, 3, low=-0.5, high=0.5)
    return [
        Case("_linalg_gemm", [A, B, C], {"alpha": 0.5, "beta": 2.0},
             tol=NN),
        Case("_linalg_gemm", [_f(4, 3), _f(5, 4), _f(3, 5)],
             {"transpose_a": True, "transpose_b": True}, tol=NN),
        Case("_linalg_gemm2", [A, B], {"alpha": 1.5}, tol=NN),
        Case("_linalg_gemm2", [_f(2, 4, 3), B], {"transpose_a": True},
             tol=NN),
        Case("_linalg_potrf", [spd], tol=LINALG),
        Case("_linalg_potri", [L], tol=LINALG),
        Case("_linalg_trsm", [L, _f(2, 4, 3)], {"alpha": 2.0},
             tol=LINALG),
        Case("_linalg_trsm", [L, _f(2, 4, 3)], {"transpose": True},
             tol=LINALG),
        Case("_linalg_trsm", [L, _f(2, 3, 4)], {"rightside": True},
             tol=LINALG),
        Case("_linalg_trsm", [np.swapaxes(L, -1, -2).copy(), _f(2, 3, 4)],
             {"rightside": True, "lower": False, "transpose": True},
             tol=LINALG),
        Case("_linalg_trmm", [_f(2, 4, 4), _f(2, 4, 3)], {"alpha": 0.5},
             tol=NN),
        Case("_linalg_trmm", [_f(4, 4), _f(3, 4)],
             {"lower": False, "rightside": True, "transpose": True},
             tol=NN),
        Case("_linalg_syrk", [A], {"alpha": 3.0}, tol=NN),
        Case("_linalg_syrk", [A], {"transpose": True}, tol=NN),
        Case("_linalg_gelqf", [_f(3, 5)], n_out=2, tol=LINALG),
        Case("_linalg_syevd", [_spd(4)], n_out=2, tol=LINALG),
        Case("_linalg_sumlogdiag", [spd], tol=LINALG),
        Case("_linalg_extractdiag", [_f(2, 3, 3)]),
        Case("_linalg_makediag", [_f(2, 3)]),
        Case("_linalg_extracttrian", [_f(2, 4, 4)]),
        Case("_linalg_extracttrian", [_f(4, 4)], {"lower": False,
                                                 "offset": 1}),
        Case("_linalg_extracttrian", [_f(4, 4)], {"offset": -1}),
        Case("_linalg_inverse", [sq], tol=LINALG),
        Case("_linalg_det", [sq], tol=LINALG),
        Case("_linalg_slogdet", [_f(2, 3, 3) + 2 * np.eye(3, dtype=np.float32)],
             n_out=2, tol=LINALG),
    ]


def _nn_cases():
    img = _f(2, 3, 4, 5)
    seq = _f(5, 3, 2)
    lens = np.array([2, 5, 3], np.float32)
    return [
        Case("UpSampling", [img], {"scale": 2, "sample_type": "nearest"}),
        Case("UpSampling", [_f(2, 3, 4, 4), _f(2, 2, 2, 2)],
             {"scale": 2, "sample_type": "nearest", "num_args": 2}),
        Case("UpSampling", [_f(2, 3, 4, 4), _f(2, 3, 2, 2)],
             {"scale": 2, "sample_type": "nearest", "num_args": 2,
              "multi_input_mode": "sum"}),
        Case("UpSampling", [img, _f(3, 1, 4, 4)],
             {"scale": 2, "sample_type": "bilinear", "num_filter": 3},
             tol=NN),
        Case("L2Normalization", [img], tol=NN),
        Case("L2Normalization", [img], {"mode": "channel", "eps": 1e-3},
             tol=NN),
        Case("L2Normalization", [img], {"mode": "spatial"}, tol=NN),
        Case("LRN", [_f(2, 5, 3, 3)], {"nsize": 3}, tol=NN),
        Case("LRN", [_f(2, 5, 3, 3)], {"nsize": 5, "alpha": 1e-3,
                                       "beta": 0.5, "knorm": 1.0}, tol=NN),
        Case("softmin", [_f(3, 5)], tol=NN),
        Case("softmin", [img], {"axis": 1}, tol=NN),
        Case("SoftmaxActivation", [img], tol=NN),
        Case("SoftmaxActivation", [img], {"mode": "channel"}, tol=NN),
        Case("LinearRegressionOutput", [_f(4, 3), _f(4, 3)], grad=[0],
             tol=NN),
        Case("MAERegressionOutput", [_f(4, 3), _f(4, 3)],
             {"grad_scale": 2.0}, grad=[0], tol=NN),
        Case("LogisticRegressionOutput", [_f(4, 3), _f(4, 3, low=0,
                                                       high=1)],
             {"grad_scale": 0.5}, grad=[0], tol=NN),
        Case("SequenceMask", [seq, lens], {"use_sequence_length": True,
                                           "value": -1.0}, grad=[0]),
        Case("SequenceMask", [_f(3, 5, 2), lens],
             {"use_sequence_length": True, "axis": 1}, grad=[0]),
        Case("SequenceMask", [seq]),
        Case("SequenceLast", [seq, lens], {"use_sequence_length": True},
             grad=[0]),
        Case("SequenceLast", [_f(3, 5, 2), lens],
             {"use_sequence_length": True, "axis": 1}, grad=[0]),
        Case("SequenceLast", [seq]),
        Case("SequenceReverse", [seq, lens], {"use_sequence_length": True},
             grad=[0]),
        Case("SequenceReverse", [seq]),
        Case("IdentityAttachKLSparseReg", [_f(3, 4)]),
        Case("RNN", [_f(3, 2, 4, low=-1, high=1),
                     # per layer and direction Wx, Wh, then the biases
                     _f(2 * 12 * (4 + 3) + 2 * 12 * (6 + 3) + 8 * 12,
                        low=-0.5, high=0.5),
                     _f(4, 2, 3, low=-0.5, high=0.5),
                     _f(4, 2, 3, low=-0.5, high=0.5)],
             {"state_size": 3, "num_layers": 2, "bidirectional": True,
              "mode": "lstm", "state_outputs": True}, tol=NN),
        Case("RNN", [_f(3, 2, 4, low=-1, high=1),
                     _f(3 * 3 * (4 + 3) + 3 * 3 * (3 + 3) + 2 * 2 * 3 * 3,
                        low=-0.5, high=0.5),
                     _f(2, 2, 3, low=-0.5, high=0.5)],
             {"state_size": 3, "num_layers": 2, "mode": "gru"}, tol=NN),
        Case("_rnn_state_like", [_f(3, 5, 2)], {"shape": (2, 0, 4),
                                               "ref_axis": 1}, grad=[]),
    ]


def _misc_cases():
    img = _f(2, 3, 6, 7)
    x = _f(4, 5)
    label = np.array([0, 4, 2, 1], np.float32)
    hist = np.array([0.0, 1.0, 1.4, 2.0, 3.5, 9.0, 9.5, -1.0, 4.4, 6.0],
                    np.float32)
    return [
        Case("MakeLoss", [x]),
        Case("MakeLoss", [x], {"grad_scale": 2.0,
                               "normalization": "batch"}),
        Case("MakeLoss", [x], {"normalization": "valid",
                               "valid_thresh": 0.5}),
        Case("SVMOutput", [x, label], grad=[0], tol=NN),
        Case("SVMOutput", [x, label], {"use_linear": True, "margin": 0.5,
                                       "regularization_coefficient": 2.0},
             grad=[0], tol=NN),
        Case("Crop", [img], {"h_w": (3, 4), "offset": (1, 2)}),
        Case("Crop", [img], {"h_w": (4, 4), "center_crop": True}),
        Case("Crop", [img, _f(1, 1, 2, 3)], {"num_args": 2}, grad=[0]),
        Case("_histogram", [hist], {"bin_cnt": 4, "range": (0.0, 9.0)},
             grad=[]),
        Case("_histogram", [hist, np.array([0.0, 1.0, 2.0, 5.0, 9.0],
                                           np.float32)], grad=[]),
        Case("_image_to_tensor", [_RNG.randint(0, 256, (4, 5, 3)).astype(
            np.uint8)]),
        Case("_image_to_tensor", [_RNG.randint(0, 256, (2, 4, 5, 3)).astype(
            np.uint8)]),
        Case("_image_normalize", [_f(3, 4, 5)],
             {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}),
        Case("_image_normalize", [img], {"mean": (0.5,), "std": (2.0,)}),
        Case("_contrib_quadratic", [x], {"a": 0.5, "b": -1.0, "c": 2.0}),
        Case("_contrib_index_copy", [_f(5, 3), np.array([0, 3], np.float32),
                                     _f(2, 3)], grad=[0, 2]),
        Case("_contrib_AdaptiveAvgPooling2D", [img],
             {"output_size": (2, 3)}, tol=NN),
        Case("_contrib_AdaptiveAvgPooling2D", [img], tol=NN),
        Case("_contrib_BilinearResize2D", [img], {"height": 9, "width": 4},
             tol=NN),
        Case("_contrib_BilinearResize2D", [img, _f(1, 1, 3, 10)],
             grad=[0], tol=NN),
        Case("_contrib_BilinearResize2D", [img], {"scale_height": 1.5,
                                                  "scale_width": 0.5},
             tol=NN),
    ]


def _contrib_cases():
    qkv = _f(4, 2, 18)
    return [
        Case("_contrib_count_sketch", [_f(3, 6), np.array(
            [[0, 3, 1, 0, 2, 3]], np.float32), np.array(
            [[1, -1, 1, 1, -1, -1]], np.float32)], {"out_dim": 4},
             grad=[0]),
        Case("_contrib_fft", [_f(2, 8)], tol=NN),
        Case("_contrib_ifft", [_f(2, 16)], tol=NN),
        Case("_contrib_interleaved_matmul_selfatt_qk", [qkv], {"heads": 2},
             tol=NN),
        Case("_contrib_interleaved_matmul_selfatt_valatt",
             [qkv, _f(4, 4, 4, low=0, high=1)], {"heads": 2}, tol=NN),
        Case("_contrib_div_sqrt_dim", [_f(2, 3, 16)]),
    ]


def _quantized_cases():
    """The int8 ops in both input layouts, their values held bit for bit.
    Their gradients reach only the float ranges, as sums over every
    output, and are held at NN."""
    data = _f(2, 3, 4)
    mn, mx = np.array([-1.5], np.float32), np.array([2.0], np.float32)
    img, w, b = _i8(2, 3, 6, 6), _i8(4, 3, 3, 3), _i8(4)
    r = [np.array([v], np.float32) for v in (-1.0, 1.2, -0.3, 0.25, -2.0,
                                             3.0)]
    return [
        Case("_contrib_quantize", [data, mn, mx], n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantize", [data, mn, mx], {"out_type": "int8"},
             n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantize_v2", [data], n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantize_v2", [data], {"min_calib_range": -1.0,
                                              "max_calib_range": 1.5},
             n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_dequantize", [_RNG.randint(0, 256, (3, 4)).astype(
            np.uint8), mn, mx], tol=EXACT, grad_tol=NN),
        Case("_contrib_dequantize", [_i8(3, 4), mn, mx], tol=EXACT, grad_tol=NN),
        Case("_contrib_requantize", [_RNG.randint(-2 ** 30, 2 ** 30, (3, 5))
                                     .astype(np.int32), mn, mx], n_out=3,
             tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_fully_connected",
             [_i8(5, 3, 2), _i8(4, 6)] + r[:4], {"num_hidden": 4,
                                                 "no_bias": True},
             n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_fully_connected",
             [_i8(5, 6), _i8(4, 6), _i8(4)] + r, {"num_hidden": 4},
             n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_conv", [img, w] + r[:4],
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "num_filter": 4, "no_bias": True}, n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_conv", [img, w, b] + r,
             {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 4},
             n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_conv", [img, _i8(4, 3, 1, 1), b] + r,
             {"kernel": (1, 1), "num_filter": 4}, n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_conv", [_i8(2, 4, 5, 5), _i8(6, 2, 3, 3)]
             + r[:4], {"kernel": (3, 3), "num_group": 2, "num_filter": 6,
                       "no_bias": True}, n_out=3, tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_flatten", [img] + r[:2], n_out=3,
             tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_pooling", [img] + r[:2],
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}, n_out=3,
             tol=EXACT, grad_tol=NN),
        Case("_contrib_quantized_pooling", [img] + r[:2],
             {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"},
             n_out=3, tol=EXACT, grad_tol=NN),
    ]


TABLES = {"elementwise": _elementwise_cases(), "reduce": _reduce_cases(),
          "tensor": _tensor_cases(), "linalg": _linalg_cases(),
          "nn": _nn_cases(), "misc": _misc_cases(),
          "contrib": _contrib_cases(), "quantized": _quantized_cases()}
TESTED = {c.name for cases in TABLES.values() for c in cases} | DETECTION


@pytest.fixture(scope="module")
def jax_reference():
    """Every table's JAX results, from one jit and one vjp."""
    results = iter(_jax_table([c for t in sorted(TABLES)
                               for c in TABLES[t]]))
    return {t: [next(results) for _ in TABLES[t]] for t in sorted(TABLES)}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_ops_match_jax_values_and_gradients(table, jax_reference):
    for c, (want, heads, want_grads) in zip(TABLES[table],
                                            jax_reference[table]):
        got, got_grads = _port_case(c, heads)
        assert len(got) == len(want), c
        for g, w in zip(got, want):
            assert g.shape == w.shape, (c, g.shape, w.shape)
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=repr(c), **c.tol)
        for g, w in zip(got_grads, want_grads):
            np.testing.assert_allclose(g, w, err_msg="grad " + repr(c),
                                       **c.grad_tol)


def test_the_port_registers_all_but_the_waiting_names():
    """The audit: the JAX package's names less the port's are exactly the
    2 that wait for a later slice, and the port has no name of its own."""
    ours, theirs = set(list_ops()), set(jax_list_ops())
    assert theirs - ours == WAITING
    assert ours <= theirs
    assert len(ours) == len(theirs) - len(WAITING)


def test_the_new_names_are_tested_and_flagged_as_in_the_jax_package():
    new = {n for n in TESTED}
    for name in new:
        op, jop = get_op(name), jax_get_op(name)
        assert op.n_outputs({"ret_typ": "both"}) == jop.n_outputs(
            {"ret_typ": "both"}), name
        assert bool(op.no_grad) == bool(jop.no_grad), name
    for name in list_ops():   # aliases of one op in both, or in neither
        for other in new:
            assert (get_op(other) is get_op(name)) == (
                jax_get_op(other) is jax_get_op(name)), (name, other)


_PROBE = np.array([-300.7, -200.2, -129.0, 130.0, 300.0, -1.7, np.nan,
                   np.inf, -np.inf, 3e9, -3e9, 2147483520.0, 127.9, -0.9],
                  np.float32)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_cast_saturates_as_xlas_convert(dtype):
    """Cast and astype to an integer type truncate toward zero, clamp to
    the type's range, send NaN to 0 and an infinity to the max or min:
    XLA's convert, which the JAX package's astype is.  torch's own
    conversion wraps on the CPU (and differs again on the card)."""
    want = jmx.nd.Cast(jmx.nd.array(_PROBE), dtype=dtype).asnumpy()
    x = tmx.nd.array(_PROBE, ctx=tmx.cpu())
    for got in (tmx.nd.Cast(x, dtype=dtype), tmx.nd.cast(x, dtype),
                x.astype(dtype)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.asnumpy(), want)
    assert np.array_equal(
        jmx.nd.array(_PROBE).astype(dtype).asnumpy(), want)
    # the same conversion where an op's output or a write takes a dtype
    y = tmx.nd.zeros((len(_PROBE),), ctx=tmx.cpu(), dtype=dtype)
    y[:] = x
    np.testing.assert_array_equal(y.asnumpy(), want)


def test_float_to_int_outputs_of_the_slice_match_jax():
    """The CPU probe across the ops this slice touches that turn floats
    into integers: index attrs, creators and the quantizers, fed values
    outside the integer range."""
    big = np.array([[3e9, -3e9, 2.7], [-2.7, 1e10, 0.0]], np.float32)
    calls = [("_full", [], {"shape": (3,), "value": 3e9, "dtype": "int32"}),
             ("_full", [], {"shape": (3,), "value": -300.5,
                            "dtype": "int8"}),
             ("ravel_multi_index", [big[:, :2] * 0 + np.float32(1e9)],
              {"shape": (4, 4)}),
             ("unravel_index", [big[0]], {"shape": (7, 5)}),
             ("_contrib_quantize", [big * 1e3, np.array([-1.0], np.float32),
                                   np.array([1.0], np.float32)],
              {"out_type": "int8"}),
             ("_contrib_quantize", [big, np.array([0.0], np.float32),
                                   np.array([1.0], np.float32)], {})]
    for name, inputs, attrs in calls:
        want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in inputs],
                                     **attrs)
        with tmx.cpu():
            got = getattr(tmx.nd, name)(*[tmx.nd.array(a, ctx=tmx.cpu())
                                          for a in inputs], **attrs)
        want = want if isinstance(want, list) else [want]
        got = got if isinstance(got, list) else [got]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy(),
                                          err_msg=name)


_METHODS = [
    ("argmin", (), {"axis": 1}), ("argmin", (), {}),
    ("argsort", (), {"is_ascend": False}), ("sort", (), {"axis": 0}),
    ("topk", (), {"k": 2, "ret_typ": "both"}),
    ("broadcast_to", ((2, 3, 4),), {}), ("clip", (-0.5, 0.7), {}),
    ("norm", (), {"ord": 1, "axis": 1}), ("norm", (), {}),
    ("pad", ("constant", (0, 0, 1, 2, 0, 1)), {"constant_value": 1.5}),
    ("repeat", (2,), {"axis": 2}), ("slice", ((0, 1), (1, 3)), {}),
    ("slice_axis", (2, 1, 3), {}), ("squeeze", (), {}),
    ("tile", ((1, 2),), {}),
]


@pytest.mark.parametrize("method,args,kwargs", _METHODS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(_METHODS)])
def test_ndarray_methods_match_jax(method, args, kwargs):
    x = _f(1, 3, 4) if method in ("broadcast_to", "squeeze") \
        else np.array([[[3, 1, 3, 2], [0, 5, 5, 1], [2, 2, 7, 1]]],
                      np.float32)
    want = getattr(jmx.nd.array(x), method)(*args, **kwargs)
    got = getattr(tmx.nd.array(x, ctx=tmx.cpu()), method)(*args, **kwargs)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **ELEM)


def test_two_array_methods_and_moveaxis_match_jax():
    x, y = _f(2, 3), _f(3, 2)
    ind = np.array([2, 0, 7, -1], np.float32)
    pairs = [
        (lambda m, a, b: a.reshape_like(b), (x, y)),
        (lambda m, a, b: a.broadcast_like(b), (_f(1, 3), x)),
        (lambda m, a, b: a.take(b, axis=1), (x, ind)),
        (lambda m, a, b: a.take(b, mode="wrap"), (y, ind)),
        (lambda m, a, b: m.nd.moveaxis(a, 0, -1), (_f(2, 3, 4), x)),
    ]
    for fn, (a, b) in pairs:
        want = fn(jmx, jmx.nd.array(a), jmx.nd.array(b)).asnumpy()
        got = fn(tmx, tmx.nd.array(a, ctx=tmx.cpu()),
                 tmx.nd.array(b, ctx=tmx.cpu())).asnumpy()
        np.testing.assert_allclose(got, want, **ELEM)


def test_nd_linalg_and_the_sym_namespaces_match_jax():
    from mxnet_tpu.ndarray import linalg as jlinalg
    from mxnet_tpu_torch.ndarray import linalg as tlinalg
    assert tlinalg.__all__ == jlinalg.__all__
    spd = _spd(3)
    for name in ("potrf", "inverse", "det", "sumlogdiag", "extractdiag"):
        want = getattr(jmx.nd.linalg, name)(jmx.nd.array(spd)).asnumpy()
        got = getattr(tmx.nd.linalg, name)(
            tmx.nd.array(spd, ctx=tmx.cpu())).asnumpy()
        np.testing.assert_allclose(got, want, **LINALG)
    for ns in ("linalg", "random", "contrib"):
        theirs = {n for n in dir(getattr(jmx.sym, ns))
                  if not n.startswith("__")}
        ours = {n for n in dir(getattr(tmx.sym, ns))
                if not n.startswith("__")}
        assert ours == theirs, ns
    # a linalg graph through the executor, JSON and values as the JAX
    # package's
    from mxnet_tpu import name as jname
    from mxnet_tpu_torch import name as tname
    graphs = []
    for mx, names in ((jmx, jname), (tmx, tname)):
        with names.NameManager():
            a = mx.sym.var("a")
            graphs.append(mx.sym.linalg.syrk(mx.sym.linalg.gemm2(
                a, a, transpose_b=True), alpha=0.5))
    assert graphs[0].tojson() == graphs[1].tojson()
    a = _f(3, 3)
    want = graphs[0].eval(ctx=jmx.cpu(), a=jmx.nd.array(a))[0].asnumpy()
    got = graphs[1].eval(ctx=tmx.cpu(), a=tmx.nd.array(
        a, ctx=tmx.cpu()))[0].asnumpy()
    np.testing.assert_allclose(got, want, **NN)


def test_positional_attributes_are_the_jax_packages():
    from mxnet_tpu.ndarray.register import _POS_ATTRS as jax_pos
    from mxnet_tpu_torch.ndarray.register import _POS_ATTRS
    assert _POS_ATTRS == jax_pos
    x = _f(2, 3)
    for name, args in (("repeat", (2, 0)), ("tile", ((2, 1),)),
                       ("broadcast_to", ((2, 2, 3),)),
                       ("slice_axis", (1, 0, 2)), ("smooth_l1", (0.5,))):
        want = getattr(jmx.nd, name)(jmx.nd.array(x), *args).asnumpy()
        got = getattr(tmx.nd, name)(tmx.nd.array(x, ctx=tmx.cpu()),
                                    *args).asnumpy()
        np.testing.assert_allclose(got, want, **ELEM)


_INT_INPUTS = {
    "int32": np.array([[2 ** 30, 2 ** 30, 2 ** 30], [-7, 3, 2 ** 20]]),
    "uint8": np.array([[200, 200, 255], [3, 0, 17]]),
    "int8": np.array([[127, 127, -128], [-5, 9, 100]]),
    "bool": np.array([[1, 0, 1], [1, 1, 1]]),
}


@pytest.mark.parametrize("dtype", sorted(_INT_INPUTS))
@pytest.mark.parametrize("op", ["sum", "prod", "nansum", "nanprod",
                                "sum_axis"])
def test_integer_reductions_keep_the_jax_dtypes(op, dtype):
    """Integer and bool sums and products give int32 (uint32 for an
    unsigned input), wrapping as XLA's integer arithmetic does:
    ``[2**30] * 3`` sums to -2**30.  ``.dtype`` reads on every result."""
    a = _INT_INPUTS[dtype]
    for kwargs in ({}, {"axis": 1}, {"axis": 0, "keepdims": True}):
        want = getattr(jmx.nd, op)(jmx.nd.array(a, dtype=dtype), **kwargs)
        got = getattr(tmx.nd, op)(tmx.nd.array(a, ctx=tmx.cpu(),
                                               dtype=dtype), **kwargs)
        assert got.dtype == want.dtype, (kwargs, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    x = tmx.nd.array(a, ctx=tmx.cpu(), dtype=dtype)
    if op == "sum":
        assert x.sum().dtype == jmx.nd.array(a, dtype=dtype).sum().dtype


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_clip_keeps_an_integer_dtype(dtype):
    """``jnp.clip``: integer bounds keep the input's dtype; a float bound
    promotes to float32."""
    a = np.array([1, 5, 9, 200])
    for bounds in ((2, 7), (0, None), (2.5, 7.5)):
        want = jmx.nd.clip(jmx.nd.array(a, dtype=dtype), *bounds)
        got = tmx.nd.clip(tmx.nd.array(a, ctx=tmx.cpu(), dtype=dtype),
                          *bounds)
        assert got.dtype == want.dtype, (bounds, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
