"""A two-stage detector (counterpart of ``example/rcnn/train_rcnn.py``:
``Backbone`` :32, ``RPN`` :45, ``RoiHead`` :61, ``synthetic_batch`` :73,
``rpn_targets`` :89 and ``main`` :121).

A compact Faster R-CNN over synthetic images, through the port's
detection ops: ``_contrib_MultiProposal`` (the RPN's proposals, their NMS
scan in the hand-written CUDA kernel on the card), ``ROIPooling`` (fixed
3 x 3 region features) and a per-ROI classification head.  The RPN and
the head train jointly with SGD; the proposals carry no gradient, as the
reference's proposal op's.  The example has only its own widths, and this
runs at them: 32 x 32 images, a stride-4 backbone of 8 and 16 channels,
one anchor a position, 4 proposals an image.

    python -m mxnet_tpu_torch.models.rcnn
    python -m mxnet_tpu_torch.models.rcnn --device cpu

``main`` returns a dict: the mean loss of each epoch, the held-out
proposal-vote accuracy and the proposals' mAP at IoU 0.3.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import autograd, gluon, initializer, metric
from .. import ndarray as nd
from .. import random as mx_random
from ..context import resolve_device
from ..gluon import block
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo.vision._device import device_scope
from ..gluon.nn import Conv2D, Dense, HybridSequential
from ..ndarray import invoke
from ..ops.contrib_ops import _generate_anchors

__all__ = ["Backbone", "RPN", "RoiHead", "synthetic_batch", "rpn_targets",
           "proposals", "main"]


class Backbone(block.HybridBlock):
    def __init__(self, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope(), device_scope(device):
            self.body = HybridSequential(prefix="")
            for ch in (8, 16):
                self.body.add(Conv2D(ch, 3, strides=2, padding=1,
                                     activation="relu"))

    def hybrid_forward(self, F, x):
        return self.body(x)


class RPN(block.HybridBlock):
    """One anchor scale a position for the demo (A = scales x ratios)."""

    def __init__(self, num_anchors, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope(), device_scope(device):
            self.conv = Conv2D(16, 3, padding=1, activation="relu")
            self.cls = Conv2D(2 * num_anchors, 1)
            self.bbox = Conv2D(4 * num_anchors, 1)

    def hybrid_forward(self, F, feat):
        t = self.conv(feat)
        return self.cls(t), self.bbox(t)


class RoiHead(block.HybridBlock):
    def __init__(self, num_classes, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope(), device_scope(device):
            self.fc = Dense(32, activation="relu")
            self.cls = Dense(num_classes + 1)

    def hybrid_forward(self, F, pooled):
        return self.cls(self.fc(pooled.reshape((pooled.shape[0], -1))))


def synthetic_batch(rng, n, img):
    """(images, image class, boxes (n, 1, 5) [cls, box / img])."""
    x = rng.uniform(0, 0.1, (n, 3, img, img)).astype(np.float32)
    cls = np.zeros((n,), np.int64)
    boxes = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        c = rng.randint(0, 2)
        s = img // 2
        y0, x0 = rng.randint(0, img - s, 2)
        x[i, c, y0:y0 + s, x0:x0 + s] = 1.0
        cls[i] = c
        boxes[i, 0] = [c, x0 / img, y0 / img, (x0 + s) / img, (y0 + s) / img]
    return x, cls, boxes


def rpn_targets(boxes_np, img, fs, base_anchor):
    """Anchor-wise RPN targets (the reference AnchorLoader's role):
    objectness is the anchor centre inside the gt box; the box targets are
    RCNN's encoding, which the Proposal op decodes (+1-pixel widths, exp
    size deltas).  One anchor a position.  Returns (obj (N, H, W), bbox_t
    (N, 4, H, W), pos (N, H, W)) numpy arrays."""
    N = boxes_np.shape[0]
    H = W = img // fs
    aw = base_anchor[2] - base_anchor[0] + 1.0
    ah = base_anchor[3] - base_anchor[1] + 1.0
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    acx = base_anchor[0] + 0.5 * (aw - 1.0) + gx * fs
    acy = base_anchor[1] + 0.5 * (ah - 1.0) + gy * fs
    obj = np.zeros((N, H, W), np.float32)
    bbox_t = np.zeros((N, 4, H, W), np.float32)
    for i in range(N):
        x0, y0, x1, y1 = boxes_np[i, 0, 1:5] * img
        gw, gh = x1 - x0 + 1.0, y1 - y0 + 1.0
        gcx, gcy = x0 + 0.5 * (gw - 1.0), y0 + 0.5 * (gh - 1.0)
        inside = ((acx >= x0) & (acx <= x1) & (acy >= y0) & (acy <= y1))
        obj[i] = inside
        bbox_t[i, 0] = (gcx - acx) / aw
        bbox_t[i, 1] = (gcy - acy) / ah
        bbox_t[i, 2] = np.log(gw / aw)
        bbox_t[i, 3] = np.log(gh / ah)
    return obj, bbox_t, obj.copy()


FS, SCALES, RATIOS, POST_N = 4, (2.0,), (1.0,), 4


def proposals(rpn_cls, rpn_bbox, im_info):
    """The example's ``_contrib_MultiProposal`` call: (N * 4, 5) rois."""
    return invoke("_contrib_MultiProposal",
                  [nd.softmax(rpn_cls, axis=1), rpn_bbox, im_info],
                  {"rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": POST_N,
                   "feature_stride": FS, "scales": SCALES,
                   "ratios": RATIOS, "rpn_min_size": 1, "threshold": 0.7})


def roi_features(feat, rois):
    return invoke("ROIPooling", [feat, rois],
                  {"pooled_size": (3, 3), "spatial_scale": 1.0 / FS})


def step_loss(blocks, x, obj_t, bbox_t, pos, cls_np, im_info):
    """One step's loss (record it) and the proposals: the head's
    cross-entropy over every proposal (each takes its image's class),
    objectness cross-entropy over every anchor, smooth-L1 (sigma 3) on the
    positives' boxes."""
    backbone, rpn, head = blocks
    ctx = x.context
    feat = backbone(x)
    rpn_cls, rpn_bbox = rpn(feat)
    rois = proposals(rpn_cls, rpn_bbox, im_info)
    logits = head(roi_features(feat, rois))
    roi_y = nd.array(np.repeat(cls_np, POST_N).astype(np.float32), ctx=ctx)
    l_head = SoftmaxCrossEntropyLoss()(logits, roi_y).mean()
    logp = nd.log_softmax(nd.transpose(rpn_cls, axes=(0, 2, 3, 1)),
                          axis=-1)
    l_obj = -nd.pick(logp, obj_t, axis=-1).mean()
    n_pos = nd.maximum(pos.sum(), nd.array([1.0], ctx=ctx))
    l_box = invoke("smooth_l1", [(rpn_bbox - bbox_t) * pos],
                   {"scalar": 3.0}).sum() / n_pos
    return l_head + l_obj + l_box, rois


def build(ctx):
    """The three blocks, Xavier-initialized."""
    blocks = (Backbone(device=ctx), RPN(len(SCALES) * len(RATIOS),
                                        device=ctx),
              RoiHead(num_classes=2, device=ctx))
    for blk in blocks:
        blk.initialize(initializer.Xavier())
    return blocks


def main(argv=None):
    """The example's loop: ``--epochs`` of ``--iters`` steps from weights
    seeded with 0, then the held-out proposal-vote accuracy and
    mAP@0.3."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--img-size", type=int, default=32)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    ctx = resolve_device(args.device)

    mx_random.seed(0)
    blocks = build(ctx)
    params = {}
    for blk in blocks:
        params.update(blk.collect_params())
    trainer = gluon.Trainer(params, "sgd",
                            {"learning_rate": 0.02, "momentum": 0.9})
    rng = np.random.RandomState(0)
    im_info = nd.array(np.tile([args.img_size, args.img_size, 1.0],
                               (args.batch_size, 1)).astype(np.float32),
                       ctx=ctx)
    base_anchor = _generate_anchors(FS, RATIOS, SCALES)[0]
    losses = []
    for epoch in range(args.epochs):
        total = 0.0
        for _ in range(args.iters):
            x_np, cls_np, boxes_np = synthetic_batch(rng, args.batch_size,
                                                     args.img_size)
            obj_np, bbt_np, pos_np = rpn_targets(boxes_np, args.img_size,
                                                 FS, base_anchor)
            with autograd.record():
                loss, _ = step_loss(blocks, nd.array(x_np, ctx=ctx),
                                 nd.array(obj_np, ctx=ctx),
                                 nd.array(bbt_np, ctx=ctx),
                                 nd.array(pos_np[:, None], ctx=ctx),
                                 cls_np, im_info)
            loss.backward()
            trainer.step(1)
            total += float(loss.asnumpy().sum())
        losses.append(total / args.iters)
        print("epoch %d loss %.4f" % (epoch, losses[-1]), flush=True)

    # the head classifies proposals of held-out images
    backbone, rpn, head = blocks
    x_np, cls_np, boxes_np = synthetic_batch(rng, 8, args.img_size)
    feat = backbone(nd.array(x_np, ctx=ctx))
    rpn_cls, rpn_bbox = rpn(feat)
    rois = proposals(rpn_cls, rpn_bbox, nd.array(np.tile(
        [args.img_size, args.img_size, 1.0], (8, 1)).astype(np.float32),
        ctx=ctx))
    logits = head(roi_features(feat, rois))
    pred = logits.asnumpy().argmax(1).reshape(8, POST_N)
    votes = np.array([np.bincount(p, minlength=3).argmax() for p in pred])
    acc = float((votes == cls_np).mean())
    print("held-out proposal-vote accuracy: %.2f" % acc)
    # each proposal a detection [cls, score, box / img], scored with the
    # shared VOC mAP metric
    probs = nd.softmax(logits, axis=-1).asnumpy()
    roi_np = rois.asnumpy().reshape(8, POST_N, 5)
    dets = np.zeros((8, POST_N, 6), np.float32)
    dets[:, :, 0] = probs.argmax(-1).reshape(8, POST_N)
    dets[:, :, 1] = probs.max(-1).reshape(8, POST_N)
    dets[:, :, 2:6] = roi_np[:, :, 1:5] / args.img_size
    m = metric.VOCMApMetric(ovp_thresh=0.3)
    m.update([boxes_np], [dets])
    mean_ap = m.get()[1]
    print("proposal mAP@0.3: %.3f" % mean_ap)
    return {"epoch_loss": losses, "vote_accuracy": acc, "map": mean_ap}


if __name__ == "__main__":
    main(sys.argv[1:])
