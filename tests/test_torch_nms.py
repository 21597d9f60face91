"""Greedy NMS on an adversarial set: the port's three NMS ops against the
JAX package's on the CPU, and the word layout of the port's kernels.

The set (``_special_boxes``) holds box pairs whose IoU is exactly the
threshold (dyadic coordinates: corner [0,0,4,4] / [0,0,4,2] at 0.5), a
pair whose IoU rounds to exactly float32(0.3) ([0,0,6.5,1] / [3.5,0,10,1]:
inter 3, union 10, so only a float32 comparison keeps both), zero-area and
inverted boxes, +-inf and NaN coordinates, equal, unequal and NaN class
ids, and K not a multiple of 64 (70) and K = 1.  Scores hold no NaN: the
two packages sort NaN differently.  Every float operation on these boxes
is exact or IEEE-rounded in both packages, so the keep decisions must be
equal: the outputs are compared with bound 0 (EXACT).  On the card,
``chip_smoke.py``'s ``greedy_nms_ties`` holds the kernels to the same kind
of set.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import contrib_ops, nms_ops

EXACT = dict(rtol=0, atol=0)
INF, NAN = np.inf, np.nan


def _special_boxes():
    return np.array([
        [0, 0, 4, 4], [0, 0, 4, 2],            # IoU exactly 0.5
        [0, 0, 6.5, 1], [3.5, 0, 10, 1],       # IoU rounds to f32(0.3)
        [1, 1, 1, 1], [2, 2, 2, 5],            # zero area
        [3, 3, 1, 1], [5, 0, 4, 4],            # inverted
        [-INF, 0, INF, 1], [0, -INF, 1, INF], [-INF, -INF, INF, INF],
        [INF, INF, INF, INF], [-INF, -INF, -INF, -INF],
        [NAN, 0, 1, 1], [0, 0, NAN, 1], [NAN, NAN, NAN, NAN]], np.float32)


def _boxes(rng, n):
    """n boxes: the special ones at seeded places among quarter-pixel
    boxes that overlap them and each other."""
    lo = rng.randint(0, 40, (n, 2)) / 4
    boxes = np.concatenate([lo, lo + rng.randint(0, 32, (n, 2)) / 4],
                           axis=1).astype(np.float32)
    special = _special_boxes()[:n]
    boxes[rng.permutation(n)[:len(special)]] = special
    return boxes


def _box_nms_data(seed, N):
    """(2, N, 6) [id, score, x1, y1, x2, y2]: ids 0-2 and one NaN, distinct
    scores but one tie, a few below the valid threshold."""
    rng = np.random.RandomState(seed)
    data = np.zeros((2, N, 6), np.float32)
    for b in range(2):
        data[b, :, 0] = rng.randint(0, 3, N)
        data[b, :, 1] = rng.permutation(N) / N + 0.01
        data[b, :, 2:] = _boxes(rng, N)
    data[0, rng.randint(0, N), 0] = NAN
    if N > 2:
        data[1, 1, 1] = data[1, 2, 1]          # a tied score
        data[1, :3, 1] -= 0.5                  # below valid_thresh 0
    return data


def _detection_inputs(seed, A):
    """MultiBoxDetection over the set as anchors, zero offsets (the decoded
    boxes are the anchors exactly, or NaN where an anchor is infinite)."""
    rng = np.random.RandomState(seed)
    anchors = _boxes(rng, A)[None]
    probs = rng.uniform(0.05, 1.0, (2, 3, A)).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    return [probs, np.zeros((2, A * 4), np.float32), anchors]


PROPOSAL = {"rpn_pre_nms_top_n": 70, "rpn_post_nms_top_n": 40,
            "rpn_min_size": 4, "feature_stride": 16,
            "scales": (1.0, 2.0, 4.0), "ratios": (1.0,)}


def _proposal_inputs(seed):
    """One image, 3 anchors a position over 4 x 6 (72 boxes, 70 into the
    NMS): zero deltas (the boxes are the clipped anchors, dyadic) but for
    +-inf and NaN ones (full-width, inverted and NaN boxes)."""
    rng = np.random.RandomState(seed)
    A, H, W = 3, 4, 6
    cls = rng.uniform(size=(1, 2 * A, H, W)).astype(np.float32)
    bbox = np.zeros((1, 4 * A, H, W), np.float32)
    for value in (INF, -INF, NAN):
        for _ in range(2):
            bbox[0, rng.randint(0, 4 * A), rng.randint(0, H),
                 rng.randint(0, W)] = value
    return [cls, bbox, np.array([[64.0, 96.0, 1.0]], np.float32)]


def _proposal_tie(inputs):
    """A threshold that some pair of the proposal candidates meets exactly:
    the float32 IoU of the first overlapping pair above 0.2."""
    boxes, _ = contrib_ops.proposal_candidates(
        PROPOSAL, *(torch.from_numpy(a) for a in inputs))
    iou = nms_ops.proposal_mask(boxes, 0.2)   # the pairs above 0.2
    b = boxes[0].numpy().astype(np.float32)
    j, i = [int(v) for v in np.argwhere(np.triu(iou[0].numpy(), 1))[0]]
    one = np.float32(1)
    area = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    inter = (np.maximum(min(b[j, 2], b[i, 2]) - max(b[j, 0], b[i, 0]) + one,
                        np.float32(0))
             * np.maximum(min(b[j, 3], b[i, 3]) - max(b[j, 1], b[i, 1]) + one,
                          np.float32(0)))
    return float(inter / (area[j] + area[i] - inter))


CASES = [
    ("_contrib_box_nms", lambda: [_box_nms_data(1, 70)],
     {"overlap_thresh": 0.5}),
    ("_contrib_box_nms", lambda: [_box_nms_data(2, 70)],
     {"overlap_thresh": 0.5, "force_suppress": True}),
    ("_contrib_box_nms", lambda: [_box_nms_data(3, 70)],
     {"overlap_thresh": 0.3}),
    ("_contrib_box_nms", lambda: [_box_nms_data(4, 70)],
     {"overlap_thresh": 0.3, "force_suppress": True}),
    ("_contrib_box_nms", lambda: [_box_nms_data(5, 1)],
     {"overlap_thresh": 0.5}),
    ("_contrib_MultiBoxDetection", lambda: _detection_inputs(6, 70),
     {"nms_threshold": 0.5}),
    ("_contrib_MultiBoxDetection", lambda: _detection_inputs(7, 70),
     {"nms_threshold": 0.3, "force_suppress": True}),
    ("_contrib_Proposal", lambda: _proposal_inputs(8),
     dict(PROPOSAL, threshold=0.7, output_score=True)),
    ("_contrib_Proposal", lambda: _proposal_inputs(9), "tie"),
]


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=["%s-%d" % (c[0], k) for k, c in
                              enumerate(CASES)])
def test_nms_ops_match_jax_on_the_adversarial_set(k):
    name, make, attrs = CASES[k]
    inputs = make()
    if attrs == "tie":
        attrs = dict(PROPOSAL, threshold=_proposal_tie(inputs),
                     output_score=True)
    want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in inputs],
                                 **attrs)
    with tmx.cpu():
        got = getattr(tmx.nd, name)(
            *[tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype) for a in inputs],
            **attrs)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **EXACT)


def _box_nms_int_data(seed, N):
    """``_box_nms_data`` with integer values: scores are ranks (the tie
    and the ones below the valid threshold kept), boxes in quarter pixels,
    infinities +-99, NaNs 0, the NaN id 7."""
    data = _box_nms_data(seed, N)
    data[..., 1] = np.round(data[..., 1] * N)
    data[..., 2:] = np.nan_to_num(data[..., 2:] * 4, nan=0, posinf=99,
                                  neginf=-99)
    data[..., 0] = np.nan_to_num(data[..., 0], nan=7)
    return data


DTYPE_CASES = [
    ("_contrib_box_nms", "float16", lambda: [_box_nms_data(10, 70)],
     {"overlap_thresh": 0.5}),
    ("_contrib_box_nms", "float16", lambda: [_box_nms_data(11, 70)],
     {"overlap_thresh": 0.3, "force_suppress": True}),
    ("_contrib_box_nms", "bfloat16", lambda: [_box_nms_data(12, 70)],
     {"overlap_thresh": 0.5}),
    ("_contrib_box_nms", "float64", lambda: [_box_nms_data(13, 70)],
     {"overlap_thresh": 0.3}),
    ("_contrib_box_nms", "int32", lambda: [_box_nms_int_data(16, 70)],
     {"overlap_thresh": 0.5}),
    ("_contrib_MultiBoxDetection", "float16",
     lambda: _detection_inputs(14, 70), {"nms_threshold": 0.5}),
    ("_contrib_MultiBoxDetection", "float64",
     lambda: _detection_inputs(15, 70), {"nms_threshold": 0.3}),
]


@pytest.mark.parametrize("k", range(len(DTYPE_CASES)),
                         ids=["%s-%s-%d" % (c[0], c[1], k) for k, c in
                              enumerate(DTYPE_CASES)])
def test_nms_ops_match_jax_in_other_dtypes(k):
    """The adversarial set's inputs cast to float16, bfloat16 or float64
    (the JAX side with 64-bit types on), in both packages: every float
    operation rounds to the dtype, so the outputs are EXACT.  box_nms on
    int32 data: both IoUs in float32 from the integer coordinates.
    MultiBoxDetection's class ids stay float32 beside boxes of the dtype,
    as in both packages."""
    import jax

    name, dtype, make, attrs = DTYPE_CASES[k]
    inputs = make()
    with jax.enable_x64(dtype == "float64"):
        want = getattr(jmx.nd, name)(
            *[jmx.nd.array(a, dtype="float32").astype(dtype)
              for a in inputs], **attrs).asnumpy().astype(np.float64)
    with tmx.cpu():
        got = getattr(tmx.nd, name)(
            *[tmx.nd.array(a, ctx=tmx.cpu(), dtype="float32").astype(dtype)
              for a in inputs], **attrs)
    np.testing.assert_allclose(got.asnumpy().astype(np.float64), want,
                               **EXACT)


def _numpy_scan(words, init):
    """Greedy NMS over the kernels' word layout, in numpy: a candidate not
    yet removed is kept and removes the later candidates its row's words
    name."""
    B, K, W = words.shape
    bits = np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little")[..., :K].astype(bool)
    keep = np.zeros((B, K), bool)
    for b in range(B):
        removed = ~init[b]
        for i in range(K):
            if not removed[i]:
                keep[b, i] = True
                removed |= bits[b, i]
    return keep


def test_pack_words_round_trips_and_its_scan_is_the_plain_scan():
    rng = np.random.RandomState(19)
    B, K = 3, 150
    sup = rng.uniform(size=(B, K, K)) < 0.1
    init = rng.uniform(size=(B, K)) < 0.85
    words = nms_ops.pack_words(torch.from_numpy(sup)).numpy()
    assert words.shape == (B, K, (K + 63) // 64) and words.dtype == np.int64
    bits = np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)
    np.testing.assert_array_equal(bits[..., :K], np.triu(sup, 1))
    assert not bits[..., K:].any()
    want = nms_ops.greedy_nms_reference(torch.from_numpy(sup),
                                        torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(_numpy_scan(words, init), want)
