"""The detection and spatial ops of mxnet_tpu_torch against mxnet_tpu on
the CPU: the 17 op names of the detection slice, values and gradients,
and the greedy NMS scan's plain version against a numpy loop.

The harness is tests/test_torch_ndarray.py's: the JAX side of the table
runs in one ``jax.jit`` and one ``jax.vjp`` with seeded head gradients
(compiled once, in a module fixture), the port's eagerly through
``mxnet_tpu_torch.nd`` and ``backward``.  Bounds are the JAX package's own
tests': tests/test_vision_ops.py's and tests/test_contrib_ops.py's rtol
1e-4 / atol 1e-5 (NN) for the pooling, sampling, correlation,
deformable and multibox ops; test_vision_ops.py's
``test_proposal_nms_matches_numpy_oracle`` rtol 1e-4 / atol 1e-3
(PROPOSAL) for the proposals; ``assert_almost_equal``'s rtol 1e-5 /
atol 1e-6 (ELEM) for box IoU and the grids; and 0 (EXACT) for the
matchings and the NMS keep decisions, which are integers and booleans.

The SSD's own call of ``MultiBoxTarget`` (mining 3:1) and of
``MultiBoxDetection`` (NMS 0.45) are held in
tests/test_torch_detection_models.py, on the model's outputs.

The NMS inputs hold equal scores (the stable sort's order decides) and
box pairs whose IoU is exactly the threshold (dyadic coordinates, so every
float operation is exact in both packages): the keep sets must be equal,
which the EXACT comparison of the kept rows shows.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu_torch.ops import nms_ops
from test_torch_ndarray import Case, _jax_table, _outputs, _port_case

ELEM = dict(rtol=1e-5, atol=1e-6)
NN = dict(rtol=1e-4, atol=1e-5)
PROPOSAL = dict(rtol=1e-4, atol=1e-3)
EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _two_threads():
    """The port's small CPU ops run beside the JAX package's compiler
    threads and the suite's other workers; two intra-op threads keep them
    from crowding either."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

_RNG = np.random.RandomState(18)


def _f(*shape, low=-1.0, high=1.0):
    return _RNG.uniform(low, high, shape).astype(np.float32)


def _boxes(n, lo=0.0, hi=1.0, min_size=0.05):
    """n corner boxes inside [lo, hi]^2."""
    a = _RNG.uniform(lo, hi - min_size, (n, 2))
    size = _RNG.uniform(min_size, (hi - lo) / 2, (n, 2))
    b = np.minimum(a + size, hi)
    return np.concatenate([a, b], axis=1).astype(np.float32)


def _rois(R, N, side):
    """(R, 5) [batch, x1, y1, x2, y2] in image pixels, some past the map."""
    b = _RNG.randint(0, N, (R, 1)).astype(np.float32)
    xy = _RNG.uniform(-2, side - 3, (R, 2))
    wh = _RNG.uniform(1.5, side / 2, (R, 2))
    return np.concatenate([b, xy, xy + wh], axis=1).astype(np.float32)


def _ssd_inputs():
    """Dyadic anchors (multiples of 1/8): with zero deltas the decoded
    boxes are the anchors exactly, pairs of them overlap at IoU 1/2
    exactly, and two anchors share a score."""
    anchors = np.array([[0, 0, 4, 4], [0, 0, 4, 2], [0, 0, 2, 4],
                        [1, 1, 5, 5], [4, 4, 8, 8], [4, 4, 8, 6],
                        [6, 6, 8, 8], [2, 0, 6, 4]], np.float32) / 8
    A = len(anchors)
    probs = _RNG.uniform(0.05, 1.0, (2, 4, A)).astype(np.float32)
    probs[:, 1, 1] = probs[:, 1, 0] = 0.9       # tie at the top, class 0
    probs[:, 2:, :2] = 0.01
    probs /= probs.sum(axis=1, keepdims=True)
    loc = np.zeros((2, A * 4), np.float32)
    loc[1] = _f(A * 4, low=-0.3, high=0.3)
    return probs, loc, anchors[None]


def _box_nms_data():
    boxes = np.array([[0, 0, 2, 2], [0, 0, 2, 1], [0, 0, 2, 2],
                      [1, 0, 3, 2], [4, 4, 6, 6], [4, 4, 6, 5]], np.float32)
    ids = np.array([0, 0, 1, 0, 1, 1], np.float32)
    score = np.array([0.9, 0.8, 0.9, 0.7, 0.6, 0.6], np.float32)
    one = np.concatenate([ids[:, None], score[:, None], boxes], axis=1)
    two = one[_RNG.permutation(6)].copy()
    two[:, 1] = np.round(_RNG.uniform(0, 1, 6), 1)
    return np.stack([one, two])


def _multibox_target_inputs():
    A = 12
    anchors = _boxes(A)[None]
    labels = np.full((3, 4, 5), -1.0, np.float32)
    for n, m in ((0, 2), (1, 4)):
        labels[n, :m, 0] = _RNG.randint(0, 3, m)
        labels[n, :m, 1:] = _boxes(m, min_size=0.2)
    labels[0, 1, 1:] = anchors[0, 5]           # gt on an anchor: IoU 1
    labels[1, 3, 1:] = anchors[0, 5]           # shared best anchor
    preds = _f(3, 4, A, low=-3, high=3)
    return anchors, labels, preds


def _proposal_inputs(N, A, H, W):
    cls = _RNG.uniform(size=(N, 2 * A, H, W)).astype(np.float32)
    bbox = (_RNG.randn(N, 4 * A, H, W) * 0.1).astype(np.float32)
    return cls, bbox


def _detection_cases():
    feat = _f(2, 3, 5, 4)
    probs, loc, anchors = _ssd_inputs()
    mb_anchors, mb_labels, mb_preds = _multibox_target_inputs()
    cls, bbox = _proposal_inputs(2, 3, 4, 5)
    im_info = np.array([[64.0, 80.0, 1.0], [48.0, 64.0, 1.5]], np.float32)
    prop = {"rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
            "threshold": 0.6, "rpn_min_size": 4, "feature_stride": 16,
            "scales": (1.0, 2.0, 4.0), "ratios": (1.0,)}
    data = _f(2, 3, 8, 9)
    rois = _rois(5, 2, 12)
    ps_data = _f(2, 2 * 9, 8, 8)
    ps_rois = _rois(4, 2, 14)
    trans = _f(4, 4, 2, 2, low=-0.5, high=0.5)
    score = np.round(_f(2, 3, 4, low=0, high=1), 1)
    grid = _f(2, 2, 4, 4, low=-1.2, high=1.2)
    theta = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, -0.1],
                      [1.2, -0.2, 0.1, 0.3, 0.8, 0.0]], np.float32)
    return [
        Case("_contrib_MultiBoxPrior", [feat],
             {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5)}, grad=[]),
        Case("_contrib_MultiBoxPrior", [feat],
             {"sizes": (0.25,), "ratios": (1.0, 3.0), "steps": (0.2, 0.25),
              "offsets": (0.25, 0.75)}, grad=[]),
        Case("_contrib_box_iou", [_boxes(4), _boxes(3)], grad=[],
             tol=ELEM),
        Case("_contrib_box_iou", [_boxes(2, 0.2, 0.8), _boxes(3, 0.2, 0.8)],
             {"format": "center"}, grad=[], tol=ELEM),
        Case("_contrib_MultiBoxTarget", [mb_anchors, mb_labels, mb_preds],
             n_out=3, grad=[], tol=NN),
        Case("_contrib_MultiBoxTarget", [mb_anchors, mb_labels, mb_preds],
             {"negative_mining_ratio": 1.0, "minimum_negative_samples": 5,
              "overlap_threshold": 0.3, "ignore_label": -2.0}, n_out=3,
             grad=[], tol=NN),
        Case("_contrib_MultiBoxDetection", [probs, loc, anchors],
             {"nms_threshold": 0.5, "threshold": 0.2, "nms_topk": 3},
             grad=[], tol=NN),
        Case("_contrib_box_nms", [_box_nms_data()[None].repeat(2, 0)],
             {"overlap_thresh": 0.5}, grad=[], tol=EXACT),
        Case("_contrib_box_nms", [_box_nms_data()],
             {"overlap_thresh": 0.3, "force_suppress": True,
              "valid_thresh": 0.1}, grad=[], tol=EXACT),
        Case("ROIPooling", [data, rois],
             {"pooled_size": (2, 3), "spatial_scale": 0.5}, grad=[0],
             tol=NN),
        Case("_contrib_ROIAlign", [data, rois],
             {"pooled_size": (1, 1), "spatial_scale": 0.5,
              "sample_ratio": 0}, grad=[0, 1], tol=NN),
        Case("_contrib_PSROIPooling", [ps_data, ps_rois],
             {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3},
             grad=[0], tol=NN),
        Case("_contrib_DeformablePSROIPooling", [ps_data, ps_rois, trans],
             {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
              "pooled_size": 3, "part_size": 2, "sample_per_part": 1,
              "trans_std": 0.1}, n_out=2, grad=[0, 2], tol=NN),
        Case("_contrib_DeformablePSROIPooling", [ps_data, ps_rois],
             {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
              "sample_per_part": 2, "no_trans": True}, n_out=2, grad=[0],
             tol=NN),
        Case("_contrib_DeformableConvolution",
             [_f(2, 4, 7, 7), _f(2, 2 * 2 * 9, 3, 4, low=-1.5, high=1.5),
              _f(6, 2, 3, 3), _f(6)],
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "dilate": (2, 1), "num_filter": 6, "num_group": 2,
              "num_deformable_group": 2}, tol=NN),
        Case("_contrib_Proposal", [cls, bbox, im_info],
             dict(prop, output_score=True), n_out=2, grad=[],
             tol=PROPOSAL),
        Case("_contrib_MultiProposal", [cls, bbox, im_info],
             dict(prop, threshold=0.3, rpn_post_nms_top_n=50), grad=[],
             tol=PROPOSAL),
        Case("_contrib_bipartite_matching", [score], {"threshold": 0.3},
             n_out=2, grad=[], tol=EXACT),
        Case("_contrib_bipartite_matching", [score],
             {"threshold": 0.6, "is_ascend": True, "topk": 2}, n_out=2,
             grad=[], tol=EXACT),
        Case("Correlation", [_f(2, 2, 6, 7), _f(2, 2, 6, 7)],
             {"kernel_size": 3, "max_displacement": 1, "stride1": 2,
              "pad_size": 1, "is_multiply": False}, tol=NN),
        Case("GridGenerator", [theta],
             {"transform_type": "affine", "target_shape": (4, 5)},
             tol=ELEM),
        Case("GridGenerator", [_f(2, 2, 4, 5)], {"transform_type": "warp"},
             tol=ELEM),
        Case("BilinearSampler", [data, grid], tol=NN),
        Case("SpatialTransformer", [data, theta],
             {"target_shape": (4, 4), "transform_type": "affine",
              "sampler_type": "bilinear"}, tol=NN),
    ]


CASES = _detection_cases()
NAMES = {c.name for c in CASES}


def _jax_forward(cases):
    """The outputs of cases that take no gradient, from one jit (no vjp
    to compile): (outputs, no heads, no gradients) a case."""
    def run(*vals):
        it = iter(vals)
        return [[o._data for o in _outputs(getattr(jmx.nd, c.name)(
            *[jmx.nd.NDArray(next(it)) for _ in c.inputs], **c.attrs), c)]
            for c in cases]

    outs = jax.jit(run)(*[a for c in cases for a in c.inputs])
    return [([np.asarray(o) for o in case_outs], [None] * len(case_outs),
             []) for case_outs in outs]


@pytest.fixture(scope="module")
def jax_reference():
    """Every case's JAX results: the cases with gradients from one jit and
    one vjp, the rest from one jit."""
    with_grad = [c for c in CASES if c.grad]
    results = dict(zip(map(id, with_grad), _jax_table(with_grad)))
    plain = [c for c in CASES if not c.grad]
    results.update(zip(map(id, plain), _jax_forward(plain)))
    return [results[id(c)] for c in CASES]


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[repr(c) for c in CASES])
def test_op_matches_jax_values_and_gradients(k, jax_reference):
    c = CASES[k]
    want, heads, want_grads = jax_reference[k]
    got, got_grads = _port_case(c, heads)
    assert len(got) == len(want), c
    for g, w in zip(got, want):
        assert g.shape == w.shape, (c, g.shape, w.shape)
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, err_msg=repr(c), **c.tol)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, err_msg="grad " + repr(c),
                                   **c.grad_tol)


def test_every_name_of_the_slice_has_a_case():
    from test_torch_registry_ops import DETECTION
    assert NAMES == DETECTION


def _numpy_nms(sup, init):
    keep = init.copy()
    for b in range(sup.shape[0]):
        for i in range(sup.shape[1]):
            if not keep[b, i]:
                continue
            for j in range(i):
                if keep[b, j] and sup[b, j, i]:
                    keep[b, i] = False
                    break
    return keep


def _numpy_sup(boxes, ids, thresh, form):
    """The suppression mask in numpy float32, one IEEE operation at a time:
    the JAX package's ``_box_iou_xyxy`` (corner) or Proposal's +1-pixel
    IoU, against float32(thresh)."""
    a, b = boxes[:, :, None, :], boxes[:, None, :, :]
    one = np.float32(1) if form == "proposal" else np.float32(0)
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]) + one, np.float32(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]) + one, np.float32(0))
    inter = iw * ih
    if form == "proposal":
        area = ((boxes[..., 2] - boxes[..., 0] + one)
                * (boxes[..., 3] - boxes[..., 1] + one))
        union = area[:, :, None] + area[:, None, :] - inter
    else:
        area = (np.maximum(boxes[..., 2] - boxes[..., 0], np.float32(0))
                * np.maximum(boxes[..., 3] - boxes[..., 1], np.float32(0)))
        union = np.maximum(area[:, :, None] + area[:, None, :] - inter,
                           np.float32(1e-12))
    with np.errstate(all="ignore"):
        sup = inter / union > np.float32(thresh)
    if ids is not None:
        sup &= ids[:, :, None] == ids[:, None, :]
    return sup


@pytest.mark.parametrize("B,K,thresh", [(3, 70, 0.05), (2, 130, 0.3),
                                        (1, 1, 0.5)])
def test_greedy_nms_plain_version_matches_a_numpy_loop(B, K, thresh):
    """Boxes on a quarter-pixel grid (many IoUs exactly at a threshold),
    both forms, the corner one with ids and without, against a numpy mask
    and loop."""
    rng = np.random.RandomState(K)
    lo = rng.randint(0, 24, (B, K, 2)) / 4
    boxes = np.concatenate([lo, lo + rng.randint(0, 16, (B, K, 2)) / 4],
                           axis=2).astype(np.float32)
    ids = rng.randint(0, 3, (B, K)).astype(np.float32)
    init = rng.uniform(size=(B, K)) < 0.8
    for form, with_ids in (("corner", True), ("corner", False),
                           ("proposal", False)):
        got = nms_ops.greedy_nms(
            torch.from_numpy(boxes),
            torch.from_numpy(ids) if with_ids else None,
            torch.from_numpy(init), thresh, form=form)
        want = _numpy_nms(_numpy_sup(boxes, ids if with_ids else None,
                                     thresh, form), init)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=form)
    assert nms_ops.greedy_nms.launches == 0   # the CPU runs no kernel


def test_greedy_nms_checks_its_inputs():
    boxes = torch.zeros((2, 4, 4))
    ids = torch.zeros((2, 4))
    init = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\(B, K, 4\)"):
        nms_ops.greedy_nms(boxes[:, :3], ids, init, 0.5)
    with pytest.raises(TypeError, match="bool"):
        nms_ops.greedy_nms(boxes, ids, init.float(), 0.5)
    with pytest.raises(ValueError, match="form"):
        nms_ops.greedy_nms(boxes, ids, init, 0.5, form="center")
    with pytest.raises(ValueError, match="ids"):
        nms_ops.greedy_nms(boxes, ids[:, :3], init, 0.5)
    with pytest.raises(ValueError, match="no ids"):
        nms_ops.greedy_nms(boxes, ids, init, 0.5, form="proposal")
    with pytest.raises(TypeError, match="real ids"):
        nms_ops.greedy_nms(boxes, ids.bool(), init, 0.5)
    K = nms_ops.MAX_K + 1
    with pytest.raises(ValueError, match="K <= %d" % nms_ops.MAX_K):
        nms_ops.greedy_nms(torch.zeros((1, K, 4)), None,
                           torch.ones((1, K), dtype=torch.bool), 0.5,
                           form="proposal")
    meta = nms_ops.greedy_nms(boxes.to("meta"), ids.to("meta"),
                              init.to("meta"), 0.5)
    assert meta.shape == (2, 4) and meta.device.type == "meta"


def _detection_graph(pkg):
    """A graph of detection ops in ``pkg.sym``: the RCNN head's proposal
    and ROI pooling, and the SSD's prior and detection."""
    sym = pkg.sym
    feat, cls, bbox, info = (sym.var(n) for n in ("feat", "cls", "bbox",
                                                  "info"))
    rois = sym._contrib_Proposal(cls, bbox, info, rpn_pre_nms_top_n=20,
                                 rpn_post_nms_top_n=6, feature_stride=4,
                                 scales=(2.0,), ratios=(1.0,),
                                 rpn_min_size=1)
    pooled = sym.ROIPooling(feat, rois, pooled_size=(2, 2),
                            spatial_scale=0.25)
    anchors = sym._contrib_MultiBoxPrior(feat, sizes=(0.5,),
                                         ratios=(1.0, 2.0))
    prob, loc = sym.var("prob"), sym.var("loc")
    det = sym._contrib_MultiBoxDetection(prob, loc, anchors)
    grid = sym.GridGenerator(sym.var("theta"), transform_type="affine",
                             target_shape=(3, 3))
    warped = sym.BilinearSampler(feat, grid)
    return sym.Group([pooled, det, warped])


def test_detection_ops_trace_into_sym_as_in_the_jax_package():
    """The ops compose in ``mx.sym`` to the JAX package's graph JSON, and
    shape inference (the port's on ``meta`` tensors, the NMS scan
    included) gives its shapes."""
    import mxnet_tpu_torch as tmx
    with jmx.name.NameManager():
        want = _detection_graph(jmx)
    with tmx.name.NameManager():
        got = _detection_graph(tmx)
    assert got.tojson() == want.tojson()
    shapes = dict(feat=(2, 4, 8, 8), cls=(2, 2, 2, 2), bbox=(2, 4, 2, 2),
                  info=(2, 3), prob=(2, 3, 128), loc=(2, 512),
                  theta=(2, 6))
    assert got.infer_shape(**shapes) == want.infer_shape(**shapes)
