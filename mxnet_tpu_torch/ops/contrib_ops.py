"""The contrib ops (counterpart of ``mxnet_tpu/ops/contrib_ops.py``).

Detection: ``_contrib_MultiBoxPrior`` :32, ``_box_iou_xyxy`` :67 and
``_contrib_box_iou`` :81, ``_contrib_MultiBoxTarget`` :94,
``_contrib_MultiBoxDetection`` :209, ``_contrib_box_nms`` :262,
``ROIPooling`` :313, ``_contrib_ROIAlign`` :354, ``_generate_anchors``
:405 and ``_contrib_Proposal`` :422, ``_contrib_DeformableConvolution``
:534 and ``_contrib_PSROIPooling`` :594.  Each keeps the reference's
arithmetic and order of operations; its per-sample ``vmap`` is a batch
dimension here, and its sorts are stable, as ``jnp.argsort`` is.  The
three greedy NMS ``fori_loop`` scans (:253, :298, :515) build their
suppression mask in torch ops and run the scan through
:func:`nms_ops.greedy_nms`: the hand-written CUDA kernel on the card, its
plain loop on the CPU.

Dense: ``_contrib_count_sketch`` :658, ``_contrib_fft`` :675 and
``_contrib_ifft`` :688, the interleaved self-attention products :706-732
and ``_contrib_div_sqrt_dim`` :735.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .nms_ops import greedy_nms
from .registry import register
from .tensor_ops import _index

__all__ = ["greedy_nms", "nms_mask", "detection_candidates",
           "proposal_candidates", "proposal_mask", "proposal_anchors"]


# ---------------------------------------------------------------------------
# SSD: MultiBoxPrior / MultiBoxTarget / MultiBoxDetection
# ---------------------------------------------------------------------------

def _maximum(x, v):
    """``jnp.maximum(x, v)`` for a scalar ``v``: ties split the gradient
    in half, as JAX's does (``clamp_min`` passes it whole)."""
    return torch.maximum(x, x.new_full((), v))


def div_const(x, c):
    """``x / c`` for a Python constant ``c`` as the JAX ops compute it:
    XLA rewrites a division by a constant as a product with its fp32
    reciprocal, and CUDA divides by a host scalar the same way, so the CPU
    path does too.  Where a bin edge is floored or ceiled, the last bit
    decides which row a bin holds."""
    return x * (1.0 / c)


@register("_contrib_MultiBoxPrior")
def _multibox_prior(attrs, data):
    """SSD anchors of an (N, C, H, W) feature map: (1, H*W*num_anchors, 4),
    every size at ratio 1, then ``ratios[1:]`` at ``sizes[0]``
    (MultiBoxPriorForward's enumeration order, which the heads' channels
    are keyed to).  A size is a fraction of the image height."""
    sizes = tuple(attrs.get("sizes", (1.0,)))
    ratios = tuple(attrs.get("ratios", (1.0,)))
    steps = attrs.get("steps", (-1.0, -1.0))
    offsets = attrs.get("offsets", (0.5, 0.5))
    H, W = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(H, **f32) + offsets[0]) * step_y
    cx = (torch.arange(W, **f32) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    aspect = float(H) / float(W)
    whs = [(s * aspect / 2, s / 2) for s in sizes]
    for r in ratios[1:]:
        sr = np.sqrt(r)
        whs.append((sizes[0] * aspect * sr / 2, sizes[0] / sr / 2))
    boxes = [torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
             for hw, hh in whs]
    return torch.stack(boxes, dim=2).reshape(1, -1, 4)


def _box_iou_xyxy(a, b):
    """IoU between (..., 4) corner boxes, broadcasting."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    iw = _maximum(ix2 - ix1, 0.0)
    ih = _maximum(iy2 - iy1, 0.0)
    inter = iw * ih
    area_a = (_maximum(a[..., 2] - a[..., 0], 0.0)
              * _maximum(a[..., 3] - a[..., 1], 0.0))
    area_b = (_maximum(b[..., 2] - b[..., 0], 0.0)
              * _maximum(b[..., 3] - b[..., 1], 0.0))
    return inter / _maximum(area_a + area_b - inter, 1e-12)


@register("_contrib_box_iou")
def _box_iou(attrs, lhs, rhs):
    a, b = lhs, rhs
    if attrs.get("format", "corner") == "center":
        def to_corner(x):
            cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
            return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2], dim=-1)
        a, b = to_corner(a), to_corner(b)
    return _box_iou_xyxy(a[..., :, None, :], b[..., None, :, :])


def _take_rows(x, idx):
    """``x[b, idx[b]]`` for each b: (B, K, ...) gathered along dim 1."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


@register("_contrib_MultiBoxTarget", num_outputs=3)
def _multibox_target(attrs, anchors, labels, cls_preds):
    """Assign ground truths to anchors (multibox_target.cc): returns
    (loc_target (N, A*4), loc_mask (N, A*4), cls_target (N, A)).  labels
    (N, M, 5) [cls, 4 box]; the valid ground truths are the rows before
    the first ``cls == -1``.

    A greedy bipartite stage (each ground truth takes a distinct anchor,
    global best IoU first: the flattened argmax's first maximum), then
    every other anchor takes its best ground truth above
    ``overlap_threshold``.  ``negative_mining_ratio`` > 0 keeps the
    ``num_positive * ratio`` hardest eligible negatives (lowest background
    probability; floor ``minimum_negative_samples``, which the JAX
    package honours as its docstring says) as background and gives the
    rest ``ignore_label``."""
    iou_thresh = float(attrs.get("overlap_threshold", 0.5))
    variances = tuple(attrs.get("variances", (0.1, 0.1, 0.2, 0.2)))
    mining_ratio = float(attrs.get("negative_mining_ratio", -1.0))
    mining_thresh = float(attrs.get("negative_mining_thresh", 0.5))
    min_negatives = int(attrs.get("minimum_negative_samples", 0))
    ignore_label = float(attrs.get("ignore_label", -1.0))
    A = anchors.shape[1]
    N, M = labels.shape[0], labels.shape[1]
    dev = labels.device
    anc = anchors[0]
    cls_col = labels[:, :, 0]
    valid = torch.cumsum((cls_col < 0).to(torch.int32), dim=1) == 0
    num_valid = valid.sum(dim=1)
    gt_boxes = labels[:, :, 1:5]
    iou = _box_iou_xyxy(anc[None, :, None, :], gt_boxes[:, None, :, :])
    iou_v = torch.where(valid[:, None, :], iou, -1.0)     # (N, A, M)

    # stage 1: M steps of the greedy bipartite match, the batch at once
    rows = torch.arange(N, device=dev)
    anchor_gt = torch.full((N, A), -1, dtype=torch.int64, device=dev)
    miou = iou_v.detach().clone()
    for _ in range(M):
        flat = miou.reshape(N, -1).argmax(dim=1)
        a, g = flat // M, flat % M
        ok = miou[rows, a, g] > 1e-6
        anchor_gt[rows, a] = torch.where(ok, g, anchor_gt[rows, a])
        miou[rows, a, :] = torch.where(ok[:, None], -1.0, miou[rows, a, :])
        miou[rows, :, g] = torch.where(ok[:, None], -1.0, miou[rows, :, g])
    forced = anchor_gt >= 0
    # stage 2: the rest take their best gt strictly above the threshold,
    # only when the threshold is positive (a static check, as the JAX op's)
    best_gt = iou_v.argmax(dim=2)
    best_iou = iou_v.amax(dim=2)
    if iou_thresh > 0:
        matched = forced | ((best_iou > iou_thresh)
                            & (num_valid > 0)[:, None])
    else:
        matched = forced
    gt_idx = torch.where(forced, anchor_gt, best_gt).clamp(0, M - 1)
    gt = _take_rows(gt_boxes, gt_idx)                      # (N, A, 4)
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    gw = _maximum(gt[..., 2] - gt[..., 0], 1e-8)
    gh = _maximum(gt[..., 3] - gt[..., 1], 1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    tx = (gcx - acx) / _maximum(aw, 1e-8) / variances[0]
    ty = (gcy - acy) / _maximum(ah, 1e-8) / variances[1]
    tw = torch.log(gw / _maximum(aw, 1e-8)) / variances[2]
    th = torch.log(gh / _maximum(ah, 1e-8)) / variances[3]
    loc = torch.stack([tx, ty, tw, th], dim=-1)
    loc = torch.where(matched[..., None], loc, 0.0)
    mask = torch.where(matched[..., None], 1.0, 0.0).expand(N, A, 4)
    mask = mask.to(loc.dtype)
    has_gt = (num_valid > 0)[:, None]
    if mining_ratio > 0:
        with torch.no_grad():
            bg_prob = torch.softmax(cls_preds, dim=1)[:, 0]   # (N, A)
            eligible = (~matched) & (best_iou < mining_thresh)
            hardness = torch.where(eligible, bg_prob, float("inf"))
            order = torch.argsort(hardness, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(A, device=dev).expand(N, A))
            num_pos = matched.sum(dim=1)
            num_neg = torch.minimum(
                _index(num_pos * mining_ratio).clamp_min(min_negatives),
                eligible.sum(dim=1))
            num_neg = torch.where(num_valid > 0, num_neg, 0)
            keep_neg = eligible & (rank < num_neg[:, None])
            background = torch.where(keep_neg, 0.0, ignore_label)
    else:
        background = torch.where(has_gt, 0.0, ignore_label).expand(N, A)
    cls_t = torch.where(matched, _take_rows(cls_col, gt_idx) + 1,
                        background.to(labels.dtype))
    return loc.reshape(N, -1), mask.reshape(N, -1), cls_t


def nms_mask(boxes, ids, thresh, force=False):
    """The suppression relation of score-sorted boxes (B, K, 4) with
    class ids (B, K): ``sup[b, j, i] = iou(j, i) > thresh`` (and the same
    id unless ``force``), the JAX ops' ``(iou > thresh) & same``.  Built
    a few batch rows at a time (~8 GiB of K x K fp32 temporaries), with
    the arithmetic of :func:`_box_iou_xyxy`."""
    B, K = ids.shape
    chunk = max(1, (8 << 30) // max(1, K * K * 4 * 10))
    sup = torch.empty((B, K, K), dtype=torch.bool, device=boxes.device)
    with torch.no_grad():
        for lo in range(0, B, chunk):
            bx = boxes[lo:lo + chunk]
            s = _box_iou_xyxy(bx[:, :, None, :], bx[:, None, :, :]) > thresh
            if not force:
                idc = ids[lo:lo + chunk]
                s &= idc[:, :, None] == idc[:, None, :]
            sup[lo:lo + chunk] = s
    return sup


def detection_candidates(attrs, cls_prob, loc_pred, anchors):
    """MultiBoxDetection up to its NMS: the decoded boxes and the best
    non-background class and score of each anchor, in score order (stable)
    -> (boxes_s (N, A, 4), score_s, cls_s, valid_s (N, A))."""
    score_thresh = float(attrs.get("threshold", 0.01))
    variances = tuple(attrs.get("variances", (0.1, 0.1, 0.2, 0.2)))
    anc = anchors[0]
    A = anc.shape[0]
    N = cls_prob.shape[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    scores = cls_prob[:, 1:, :]          # skip background class 0
    cls_id = scores.argmax(dim=1).to(torch.float32)
    score = scores.amax(dim=1)
    valid = score > score_thresh
    order = torch.argsort(-score, dim=1, stable=True)
    return (_take_rows(boxes, order), torch.gather(score, 1, order),
            torch.gather(cls_id, 1, order), torch.gather(valid, 1, order))


@register("_contrib_MultiBoxDetection")
def _multibox_detection(attrs, cls_prob, loc_pred, anchors):
    """Decode + NMS (multibox_detection.cc): returns (N, A, 6)
    [cls_id, score, xmin, ymin, xmax, ymax] in score order, suppressed or
    invalid entries with cls_id -1.  ``nms_topk`` is read and not used, as
    in the JAX op."""
    nms_thresh = float(attrs.get("nms_threshold", 0.5))
    boxes_s, score_s, cls_s, valid_s = detection_candidates(
        attrs, cls_prob, loc_pred, anchors)
    keep = greedy_nms(nms_mask(boxes_s, cls_s, nms_thresh), valid_s)
    out_cls = torch.where(keep, cls_s, -1.0)
    return torch.cat([out_cls[..., None], score_s[..., None], boxes_s],
                     dim=-1)


@register("_contrib_box_nms")
def _box_nms(attrs, data):
    """NMS over (..., N, K >= 6) [id, score, x1, y1, x2, y2]
    (bounding_box.cc): sorted by score, survivors first, suppressed rows
    all -1 and compacted to the end."""
    thresh = float(attrs.get("overlap_thresh", 0.5))
    valid_thresh = float(attrs.get("valid_thresh", 0))
    score_index = int(attrs.get("score_index", 1))
    id_index = int(attrs.get("id_index", 0))
    coord_start = int(attrs.get("coord_start", 2))
    force = bool(attrs.get("force_suppress", False))
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    score = flat[..., score_index]
    valid = score > valid_thresh
    order = torch.argsort(-score, dim=1, stable=True)
    s = _take_rows(flat, order)
    keep = greedy_nms(
        nms_mask(s[..., coord_start:coord_start + 4], s[..., id_index],
                 thresh, force=force),
        torch.gather(valid, 1, order))
    compact = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    out = torch.where(torch.gather(keep, 1, compact)[..., None],
                      _take_rows(s, compact), -1.0)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

@register("ROIPooling")
def _roi_pooling(attrs, data, rois):
    """Max-pool each ROI to a fixed grid (roi_pooling.cc).  rois (R, 5)
    [batch_idx, x1, y1, x2, y2] in image coordinates.  Each bin is one
    masked ``amax`` over the whole map (ties split the gradient as JAX's
    max does); an empty bin is 0."""
    ph, pw = tuple(attrs["pooled_size"])
    scale = float(attrs.get("spatial_scale", 1.0))
    N, C, H, W = data.shape
    R = rois.shape[0]
    b = _index(rois[:, 0])
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    rw = _maximum(x2 - x1 + 1, 1.0)
    rh = _maximum(y2 - y1 + 1, 1.0)
    bin_w = div_const(rw, pw)
    bin_h = div_const(rh, ph)
    img = data[b]                                      # (R, C, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=data.device)
    xs = torch.arange(W, dtype=torch.float32, device=data.device)
    outs = []
    for py in range(ph):
        for px in range(pw):
            y_lo = y1 + py * bin_h
            y_hi = y1 + (py + 1) * bin_h
            x_lo = x1 + px * bin_w
            x_hi = x1 + (px + 1) * bin_w
            my = (ys >= torch.floor(y_lo)[:, None]) & (
                ys < torch.ceil(y_hi)[:, None])
            mx = (xs >= torch.floor(x_lo)[:, None]) & (
                xs < torch.ceil(x_hi)[:, None])
            mask = my[:, :, None] & mx[:, None, :]     # (R, H, W)
            vals = torch.where(mask[:, None], img, float("-inf"))
            m = torch.amax(vals, dim=(2, 3))
            outs.append(torch.where(torch.isfinite(m), m, 0.0))
    return torch.stack(outs, dim=-1).reshape(R, C, ph, pw)


@register("_contrib_ROIAlign")
def _roi_align(attrs, data, rois):
    """Bilinear ROI align (roi_align.cc): ``sample_ratio`` x
    ``sample_ratio`` points a bin, each from its four clamped corners."""
    ph, pw = tuple(attrs["pooled_size"])
    scale = float(attrs.get("spatial_scale", 1.0))
    sr = int(attrs.get("sample_ratio", 2))
    if sr <= 0:
        sr = 2
    N, C, H, W = data.shape
    b = _index(rois[:, 0])

    def bilinear(y, x):
        y0 = _index(torch.floor(y)).clamp(0, H - 1)
        x0 = _index(torch.floor(x)).clamp(0, W - 1)
        y1i = (y0 + 1).clamp(0, H - 1)
        x1i = (x0 + 1).clamp(0, W - 1)
        wy = (y - y0)[:, None]
        wx = (x - x0)[:, None]
        return (data[b, :, y0, x0] * (1 - wy) * (1 - wx)
                + data[b, :, y0, x1i] * (1 - wy) * wx
                + data[b, :, y1i, x0] * wy * (1 - wx)
                + data[b, :, y1i, x1i] * wy * wx)

    x1 = rois[:, 1] * scale
    y1 = rois[:, 2] * scale
    x2 = rois[:, 3] * scale
    y2 = rois[:, 4] * scale
    bin_w = div_const(_maximum(x2 - x1, 1.0), pw)
    bin_h = div_const(_maximum(y2 - y1, 1.0), ph)
    bins = []
    for py in range(ph):
        for px in range(pw):
            acc = None
            for sy in range(sr):
                for sx in range(sr):
                    y = y1 + (py + (sy + 0.5) / sr) * bin_h
                    x = x1 + (px + (sx + 0.5) / sr) * bin_w
                    v = bilinear(y, x)
                    acc = v if acc is None else acc + v
            bins.append(div_const(acc, sr * sr))
    return torch.stack(bins, dim=-1).reshape(-1, C, ph, pw)


def _generate_anchors(feature_stride, ratios, scales):
    """py-faster-rcnn base anchors (proposal.cc GenerateAnchors), numpy:
    the JAX package's ``_generate_anchors``, copied."""
    base = np.array([0, 0, feature_stride - 1, feature_stride - 1],
                    np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size_r = (w * h) / r
        ws = np.round(np.sqrt(size_r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            anchors.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                            cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return np.asarray(anchors, np.float32)


def proposal_anchors(H, W, feature_stride, ratios, scales):
    """Every position's anchors, (H * W * A, 4) in (h, w, a) order: the
    reference's workspace layout, computed in numpy as the JAX op does."""
    base = _generate_anchors(feature_stride, ratios, scales)
    A = base.shape[0]
    sx = (np.arange(W) * feature_stride).astype(np.float32)
    sy = (np.arange(H) * feature_stride).astype(np.float32)
    shifts = np.stack(
        [np.tile(sx[None, :, None], (H, 1, A)),
         np.tile(sy[:, None, None], (1, W, A)),
         np.tile(sx[None, :, None], (H, 1, A)),
         np.tile(sy[:, None, None], (1, W, A))], axis=-1)
    return (shifts + base[None, None]).reshape(-1, 4)


def proposal_candidates(attrs, cls_prob, bbox_pred, im_info):
    """Proposal up to its NMS: the decoded, clipped and filtered boxes in
    score order (stable), the first ``rpn_pre_nms_top_n`` of them ->
    (boxes (N, K1, 4), scores (N, K1))."""
    pre_n = int(attrs.get("rpn_pre_nms_top_n", 6000))
    min_size = float(attrs.get("rpn_min_size", 16))
    scales = tuple(float(s) for s in attrs.get("scales", (4, 8, 16, 32)))
    ratios = tuple(float(r) for r in attrs.get("ratios", (0.5, 1, 2)))
    fs = int(attrs.get("feature_stride", 16))
    N, A2, H, W = cls_prob.shape
    A = A2 // 2
    dev = cls_prob.device
    anchors = torch.from_numpy(
        proposal_anchors(H, W, fs, ratios, scales)).to(dev)
    K1 = min(pre_n, H * W * A)
    im_h, im_w, im_scale = (im_info[:, k:k + 1] for k in range(3))
    score = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    d = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2)
    d = d.reshape(N, -1, 4)
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1.0)
    pred_cx = d[..., 0] * widths + ctr_x
    pred_cy = d[..., 1] * heights + ctr_y
    pred_w = torch.exp(d[..., 2]) * widths
    pred_h = torch.exp(d[..., 3]) * heights
    zero = im_h.new_zeros(())
    x1 = torch.clamp(pred_cx - 0.5 * (pred_w - 1.0), zero, im_w - 1.0)
    y1 = torch.clamp(pred_cy - 0.5 * (pred_h - 1.0), zero, im_h - 1.0)
    x2 = torch.clamp(pred_cx + 0.5 * (pred_w - 1.0), zero, im_w - 1.0)
    y2 = torch.clamp(pred_cy + 0.5 * (pred_h - 1.0), zero, im_h - 1.0)
    # positions past the real (unpadded) image extent score -1
    real_h = _index(im_h / fs)
    real_w = _index(im_w / fs)
    hh = torch.arange(H, device=dev).repeat_interleave(W * A)
    ww = torch.arange(W, device=dev).repeat_interleave(A).repeat(H)
    score = torch.where((hh >= real_h) | (ww >= real_w), -1.0, score)
    # FilterBox: boxes smaller than min_size * im_scale are inflated and
    # demoted (proposal.cc:140-158)
    ms = min_size * im_scale
    small = ((x2 - x1 + 1.0) < ms) | ((y2 - y1 + 1.0) < ms)
    x1 = torch.where(small, x1 - ms / 2, x1)
    y1 = torch.where(small, y1 - ms / 2, y1)
    x2 = torch.where(small, x2 + ms / 2, x2)
    y2 = torch.where(small, y2 + ms / 2, y2)
    score = torch.where(small, -1.0, score)
    order = torch.argsort(-score, dim=1, stable=True)[:, :K1]
    boxes = _take_rows(torch.stack([x1, y1, x2, y2], dim=-1), order)
    return boxes, torch.gather(score, 1, order)


def proposal_mask(boxes, thresh):
    """Proposal's suppression relation over its K1 candidates (B, K1, 4):
    ``sup[b, j, i] = iou(j, i) > thresh`` with the +1-pixel IoU of the
    JAX op's NMS body (its row for j), so ``supp | kill`` is the scan of
    :func:`greedy_nms` from an all-true ``init``."""
    with torch.no_grad():
        area = ((boxes[..., 2] - boxes[..., 0] + 1.0)
                * (boxes[..., 3] - boxes[..., 1] + 1.0))
        a, b = boxes[:, :, None, :], boxes[:, None, :, :]
        ix1 = torch.maximum(a[..., 0], b[..., 0])
        iy1 = torch.maximum(a[..., 1], b[..., 1])
        ix2 = torch.minimum(a[..., 2], b[..., 2])
        iy2 = torch.minimum(a[..., 3], b[..., 3])
        inter = (_maximum(ix2 - ix1 + 1.0, 0.0)
                 * _maximum(iy2 - iy1 + 1.0, 0.0))
        iou = inter / (area[:, :, None] + area[:, None, :] - inter)
        return iou > thresh


def _proposal_num_outputs(attrs):
    return 2 if attrs.get("output_score") else 1


@register("_contrib_Proposal", num_outputs=_proposal_num_outputs,
          no_grad="index-selected rois (outputs pass stop_gradient)")
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposals (proposal.cc): cls_prob (N, 2A, H, W), bbox_pred
    (N, 4A, H, W), im_info (N, 3) -> rois (N * rpn_post_nms_top_n, 5)
    [batch_idx, x1, y1, x2, y2] (+ scores (N * post, 1) with
    ``output_score``).  Fixed-size outputs: a short list of survivors is
    cycled (``keep[i % out_size]``).  No gradient, as the reference's
    backward assigns 0."""
    thresh = float(attrs.get("threshold", 0.7))
    with torch.no_grad():
        boxes, kscore = proposal_candidates(attrs, cls_prob, bbox_pred,
                                            im_info)
        init = torch.ones(kscore.shape, dtype=torch.bool,
                          device=boxes.device)
        kept = greedy_nms(proposal_mask(boxes, thresh), init)
        out, scores = proposal_select(attrs, boxes, kscore, kept)
    if attrs.get("output_score"):
        return out, scores
    return out


def proposal_select(attrs, boxes, kscore, kept):
    """Proposal after its NMS: each row's first ``rpn_post_nms_top_n``
    kept candidates, a short list cycled -> (rois (N * post, 5), scores
    (N * post, 1))."""
    post_n = int(attrs.get("rpn_post_nms_top_n", 300))
    with torch.no_grad():
        N, K1 = kscore.shape
        dev = boxes.device
        out_size = kept.sum(dim=1, keepdim=True).clamp_min(1)
        rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
        slot = torch.where(kept, rank, K1 - 1)
        keep_list = torch.zeros((N, K1), dtype=torch.int64, device=dev)
        keep_list.scatter_(1, slot,
                           torch.arange(K1, device=dev).expand(N, K1))
        idx = torch.arange(post_n, device=dev)[None, :] % out_size
        sel = torch.gather(keep_list, 1, idx.clamp(0, K1 - 1))
        rois = _take_rows(boxes, sel)
        scores = torch.gather(kscore, 1, sel)
        batch_idx = torch.arange(N, device=dev, dtype=rois.dtype)
        out = torch.cat([batch_idx.repeat_interleave(post_n)[:, None],
                         rois.reshape(-1, 4)], dim=1)
    return out, scores.reshape(-1, 1)


@register("_contrib_DeformableConvolution")
def _deformable_convolution(attrs, data, offset, weight, bias=None):
    """Deformable convolution v1 (deformable_convolution.cc): data
    (N, C, H, W), offset (N, 2 * ndg * kh * kw, Ho, Wo) of (dy, dx) pairs,
    weight (F, C / num_group, kh, kw).  Bilinear samples at the shifted
    kernel points (zero outside), then one contraction with the weights."""
    kh, kw = _pair2(attrs["kernel"])
    sh, sw = _pair2(attrs.get("stride", (1, 1)))
    ph, pw = _pair2(attrs.get("pad", (0, 0)))
    dh, dw = _pair2(attrs.get("dilate", (1, 1)))
    groups = int(attrs.get("num_group", 1))
    ndg = int(attrs.get("num_deformable_group", 1))
    N, C, H, W = data.shape
    F_ = weight.shape[0]
    K = kh * kw
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = data.device
    off = offset.reshape(N, ndg, K, 2, Ho, Wo)
    ky, kx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None]
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :]
    kern_y = torch.from_numpy(ky.reshape(-1) * dh).to(dev)[:, None, None]
    kern_x = torch.from_numpy(kx.reshape(-1) * dw).to(dev)[:, None, None]
    ys = (base_y + kern_y) + off[:, :, :, 0]      # (N, ndg, K, Ho, Wo)
    xs = (base_x + kern_x) + off[:, :, :, 1]
    Cg = C // ndg
    img = data.reshape(N, ndg, Cg, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    sampled = 0.0
    for oy, ox in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + oy, x0 + ox
        wgt = (1.0 - torch.abs(ys - yi)) * (1.0 - torch.abs(xs - xi))
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = _index(torch.clamp(yi, 0, H - 1))
        xc = _index(torch.clamp(xi, 0, W - 1))
        lin = (yc * W + xc).reshape(N, ndg, 1, -1).expand(N, ndg, Cg, -1)
        got = torch.gather(img, 3, lin).reshape(N, ndg, Cg, K, Ho, Wo)
        sampled = sampled + got * (wgt * valid)[:, :, None]
    s = sampled.reshape(N, groups, C // groups, K, Ho, Wo)
    w = weight.reshape(groups, F_ // groups, C // groups, K)
    out = torch.einsum("ngckhw,gfck->ngfhw", s, w).reshape(N, F_, Ho, Wo)
    if not attrs.get("no_bias", False) and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _pair2(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1])) if len(v) > 1 else (int(v[0]),) * 2
    return (int(v),) * 2


@register("_contrib_PSROIPooling")
def _psroi_pooling(attrs, data, rois):
    """Position-sensitive ROI pooling (psroi_pooling.cc): data
    (N, output_dim * group_size^2, H, W), rois (R, 5) ->
    (R, output_dim, pooled, pooled); each bin averages its own channel
    over its cell (two masked contractions, rows then columns, in fp32)."""
    scale = float(attrs.get("spatial_scale", 1.0))
    out_dim = int(attrs["output_dim"])
    pooled = int(attrs["pooled_size"])
    gs = int(attrs.get("group_size", 0)) or pooled
    N, C, H, W = data.shape
    dev = data.device
    batch_ind = _index(rois[:, 0])
    start_w = torch.round(rois[:, 1]) * scale
    start_h = torch.round(rois[:, 2]) * scale
    end_w = (torch.round(rois[:, 3]) + 1.0) * scale
    end_h = (torch.round(rois[:, 4]) + 1.0) * scale
    roi_w = _maximum(end_w - start_w, 0.1)
    roi_h = _maximum(end_h - start_h, 0.1)
    bin_h = div_const(roi_h, pooled)
    bin_w = div_const(roi_w, pooled)
    pidx = torch.arange(pooled, dtype=torch.float32, device=dev)
    hstart = _index(torch.clamp(torch.floor(
        pidx[None, :] * bin_h[:, None] + start_h[:, None]), 0, H))
    hend = _index(torch.clamp(torch.ceil(
        (pidx[None, :] + 1) * bin_h[:, None] + start_h[:, None]), 0, H))
    wstart = _index(torch.clamp(torch.floor(
        pidx[None, :] * bin_w[:, None] + start_w[:, None]), 0, W))
    wend = _index(torch.clamp(torch.ceil(
        (pidx[None, :] + 1) * bin_w[:, None] + start_w[:, None]), 0, W))
    hgrid = torch.arange(H, device=dev)
    wgrid = torch.arange(W, device=dev)
    mask_h = ((hgrid >= hstart[:, :, None])
              & (hgrid < hend[:, :, None])).to(data.dtype)
    mask_w = ((wgrid >= wstart[:, :, None])
              & (wgrid < wend[:, :, None])).to(data.dtype)
    gathered = data[batch_ind]                          # (R, C, H, W)
    t = torch.einsum("rchw,rph->rcpw", gathered, mask_h)
    t = torch.einsum("rcpw,rqw->rcpq", t, mask_w)
    # bin (ctop, ph, pw) reads channel (ctop * gs + gh) * gs + gw
    gh = np.clip(np.arange(pooled) * gs // pooled, 0, gs - 1)
    c_idx = ((np.arange(out_dim)[:, None, None] * gs + gh[None, :, None])
             * gs + gh[None, None, :])
    P = torch.arange(pooled, device=dev)
    sel = t[:, torch.from_numpy(c_idx).to(dev), P[None, :, None],
            P[None, None, :]]                           # (R, out_dim, P, P)
    bin_area = ((hend - hstart)[:, None, :, None]
                * (wend - wstart)[:, None, None, :]).to(data.dtype)
    return torch.where(bin_area <= 0, 0.0,
                       sel / _maximum(bin_area, 1.0))


@register("_contrib_count_sketch")
def _count_sketch(attrs, data, h, s):
    """(N, in_dim) -> (N, out_dim): out[n, h[i]] += s[i] * data[n, i]."""
    out_dim = int(attrs["out_dim"])
    idx = h.reshape(-1).long()
    signed = data * s.reshape(1, -1)
    out = torch.zeros((data.shape[0], out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, signed)


@register("_contrib_fft")
def _fft(attrs, data):
    """Unnormalized FFT over the last axis: (..., d) real -> (..., 2d),
    re and im interleaved (cuFFT's complex layout)."""
    out = torch.fft.fft(data.to(torch.float32))
    inter = torch.stack([out.real, out.imag], dim=-1)
    return inter.reshape(tuple(data.shape[:-1]) + (-1,)).to(data.dtype)


@register("_contrib_ifft")
def _ifft(attrs, data):
    """Unnormalized inverse FFT: (..., 2d) interleaved -> (..., d) real
    (d times numpy's ifft)."""
    x = data.to(torch.float32)
    x = x.reshape(tuple(x.shape[:-1]) + (-1, 2))
    comp = torch.complex(x[..., 0], x[..., 1])
    d = comp.shape[-1]
    return (torch.fft.ifft(comp).real * d).to(data.dtype)


def _heads(qkv, heads, which):
    """(T, B, 3 H D) interleaved -> part ``which`` as (B H, T, D)."""
    T, B, _ = qkv.shape
    part = qkv.reshape(T, B, heads, 3, -1)[:, :, :, which]
    D = part.shape[-1]
    return part.permute(1, 2, 0, 3).reshape(B * heads, T, D)


@register("_contrib_interleaved_matmul_selfatt_qk")
def _selfatt_qk(attrs, queries_keys_values):
    """(T, B, 3 H D) -> (B H, T, T): q k^T / sqrt(D)."""
    heads = int(attrs["heads"])
    q = _heads(queries_keys_values, heads, 0)
    k = _heads(queries_keys_values, heads, 1)
    return torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _selfatt_valatt(attrs, queries_keys_values, attention):
    """(B H, T, T) attention over the values -> (T, B, H D)."""
    heads = int(attrs["heads"])
    T, B, _ = queries_keys_values.shape
    v = _heads(queries_keys_values, heads, 2)
    out = torch.matmul(attention, v).reshape(B, heads, T, -1)
    return out.permute(2, 0, 1, 3).reshape(T, B, -1)


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(attrs, data):
    return data / math.sqrt(float(data.shape[-1]))
