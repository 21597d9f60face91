"""Single-shot detector training (counterpart of
``example/ssd/train_ssd.py``: ``MultiScaleSSD`` :44-150,
``synthetic_batch`` :153, ``evaluate_map`` :168 and ``main`` :184).

A multi-scale SSD over a model-zoo backbone, through the port's detection
ops: ``_contrib_MultiBoxPrior`` gives each scale's anchors,
``_contrib_MultiBoxTarget`` assigns the ground truths (hard-negative
mining 3:1), and ``_contrib_MultiBoxDetection`` decodes and suppresses at
inference, its NMS scan in the hand-written CUDA kernel on the card
(``ops/nms_ops.py``).  The backbone's feature pyramid is tapped where its
spatial size drops, the deepest ``num_scales`` taps kept, and extra
stride-2 blocks extend it when the backbone is too shallow.  Built as the
example builds it: the same blocks, name scopes, anchor sizes and ratios,
so the JAX model's parameters pair with these by name
(``convert.load_mxnet_params``).  ``evaluate_map`` scores held-out
synthetic images with ``metric.VOCMApMetric``.

Run on the card (default) or the CPU; ``--backbone vgg16 --num-classes 20
--img-size 300 --batch-size 32`` is PASCAL VOC's width, the upstream
example's default data shape:

    python -m mxnet_tpu_torch.models.ssd --epochs 2
    python -m mxnet_tpu_torch.models.ssd --device cpu --epochs 1 --iters 2

``main`` returns a dict: the mean loss of each epoch, the mAP before and
after training, the detections kept on the last batch, and the net.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import autograd, gluon, initializer, metric
from .. import ndarray as nd
from .. import random as mx_random
from ..context import resolve_device
from ..gluon import block
from ..gluon.model_zoo.vision._device import device_scope
from ..gluon.nn import Activation, BatchNorm, Conv2D, HybridSequential
from ..ndarray import invoke
from ..ndarray.register import tensor_ops as F

__all__ = ["MultiScaleSSD", "synthetic_batch", "evaluate_map", "ssd_loss",
           "main"]


def _downsample_block(channels):
    blk = HybridSequential(prefix="")
    blk.add(Conv2D(channels, 3, strides=2, padding=1))
    blk.add(BatchNorm())
    blk.add(Activation("relu"))
    return blk


class MultiScaleSSD(block.Block):
    """SSD heads over a feature pyramid (the reference's
    ``symbol_builder.py:60-130``).

    ``backbone``: ``'tiny'`` (3 stride-2 conv blocks) or a model-zoo name,
    whose ``features`` become the trunk.  Each scale gets its own 3x3 cls
    and loc heads; anchor sizes grow with depth (each scale pairs s_i with
    sqrt(s_i * s_{i+1})) at ratios 1, 2 and 1/2.  ``device`` (default the
    current context) is where the tensors are made."""

    def __init__(self, num_classes, backbone="tiny", num_scales=3,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.num_scales = num_scales
        lo, hi = 0.25, 0.7
        step = (hi - lo) / max(num_scales - 1, 1)
        s = [lo + i * step for i in range(num_scales)]
        s.append(min(hi + step, 1.0))
        self.scale_sizes = [(s[i], float(np.sqrt(s[i] * s[i + 1])))
                            for i in range(num_scales)]
        self.scale_ratios = [(1.0, 2.0, 0.5)] * num_scales
        num_anchors = [len(s) + len(r) - 1
                       for s, r in zip(self.scale_sizes, self.scale_ratios)]
        with self.name_scope(), device_scope(device):
            if backbone == "tiny":
                trunk = HybridSequential(prefix="backbone_")
                with trunk.name_scope():
                    for ch in (16, 32, 64):
                        trunk.add(Conv2D(ch, 3, strides=2, padding=1))
                        trunk.add(BatchNorm())
                        trunk.add(Activation("relu"))
                self.trunk = trunk
            else:
                from ..gluon.model_zoo import vision
                self.trunk = vision.get_model(backbone, classes=2).features
            self.extras = HybridSequential(prefix="extra_")
            with self.extras.name_scope():
                for _ in range(num_scales):
                    self.extras.add(_downsample_block(64))
            self.cls_heads = HybridSequential(prefix="cls_")
            self.loc_heads = HybridSequential(prefix="loc_")
            with self.cls_heads.name_scope():
                for a in num_anchors:
                    self.cls_heads.add(
                        Conv2D(a * (num_classes + 1), 3, padding=1))
            with self.loc_heads.name_scope():
                for a in num_anchors:
                    self.loc_heads.add(Conv2D(a * 4, 3, padding=1))

    def _pyramid(self, x):
        """The trunk's output at each spatial size (the last one there),
        then extra blocks; the deepest ``num_scales``, shallowest first."""
        outs = []
        for child in self.trunk._modules.values():
            y = child(x)
            if y.dim() < 4 or y.shape[2] < 2:
                break   # the pooled or flattened classifier tail
            x = y
            outs.append(x)
        taps, seen = [], set()
        for o in reversed(outs):
            if o.shape[2] not in seen:
                taps.append(o)
                seen.add(o.shape[2])
        taps.reverse()
        for blk in self.extras._modules.values():
            if len(taps) >= self.num_scales or taps[-1].shape[2] <= 2:
                break
            taps.append(blk(taps[-1]))
        return taps[-self.num_scales:]

    def forward(self, x):
        """(anchors (1, A, 4), cls (N, A, C + 1), loc (N, A * 4)), each
        scale's flattened and concatenated."""
        feats = self._pyramid(x)
        N = x.shape[0]
        anchors, cls_preds, loc_preds = [], [], []
        for i, feat in enumerate(feats):
            anchors.append(F._contrib_MultiBoxPrior(
                feat, sizes=self.scale_sizes[i],
                ratios=self.scale_ratios[i]))
            cls = self.cls_heads[i](feat)
            loc = self.loc_heads[i](feat)
            cls_preds.append(cls.permute(0, 2, 3, 1).reshape(
                N, -1, self.num_classes + 1))
            loc_preds.append(loc.permute(0, 2, 3, 1).reshape(N, -1))
        return (torch.cat(anchors, dim=1), torch.cat(cls_preds, dim=1),
                torch.cat(loc_preds, dim=1))


def synthetic_batch(rng, batch_size, img_size, num_classes):
    """Images holding one bright square each; label [cls, box / img]."""
    x = rng.uniform(0, 0.1, (batch_size, 3, img_size, img_size))
    labels = np.zeros((batch_size, 1, 5), np.float32)
    for i in range(batch_size):
        cls = rng.randint(0, num_classes)
        s = rng.randint(img_size // 4, img_size // 2)
        y0 = rng.randint(0, img_size - s)
        x0 = rng.randint(0, img_size - s)
        x[i, cls % 3, y0:y0 + s, x0:x0 + s] = 1.0
        labels[i, 0] = [cls, x0 / img_size, y0 / img_size,
                        (x0 + s) / img_size, (y0 + s) / img_size]
    return x.astype(np.float32), labels


def detect(net, x, nms_threshold=0.45, nms_topk=100):
    """``_contrib_MultiBoxDetection`` over the net's outputs: (N, A, 6)."""
    anchors, cls_f, loc_f = net(x)
    probs = nd.softmax(nd.transpose(cls_f, axes=(0, 2, 1)), axis=1)
    return invoke("_contrib_MultiBoxDetection", [probs, loc_f, anchors],
                  {"nms_threshold": nms_threshold, "threshold": 0.01,
                   "nms_topk": nms_topk})


def evaluate_map(net, rng, args, num_batches=4, ctx=None):
    """Held-out synthetic mAP through MultiBoxDetection and
    ``VOCMApMetric`` (ovp_thresh 0.5)."""
    m = metric.VOCMApMetric(ovp_thresh=0.5)
    for _ in range(num_batches):
        x_np, lab_np = synthetic_batch(rng, args.batch_size, args.img_size,
                                       args.num_classes)
        det = detect(net, nd.array(x_np, ctx=ctx))
        m.update([nd.array(lab_np, ctx=ctx)], [det])
    return m.get()[1]


def ssd_loss(anchors, cls_f, loc_f, labels, per_dev):
    """The example's multi-task loss: ``MultiBoxTarget`` with hard-negative
    mining 3:1 and ``ignore_label``, softmax cross-entropy over the valid
    anchors and smooth-L1 over the positives, times ``per_dev``."""
    loc_t, loc_m, cls_t = invoke(
        "_contrib_MultiBoxTarget",
        [anchors, labels, nd.transpose(cls_f, axes=(0, 2, 1))],
        {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5})
    ctx = cls_f.context
    valid = (cls_t >= 0).astype("float32")
    n_valid = nd.maximum(valid.sum(), nd.array([1.0], ctx=ctx))
    logp = nd.log_softmax(cls_f, axis=-1)
    per_anchor = -nd.pick(logp, nd.maximum(cls_t, nd.zeros_like(cls_t)),
                          axis=-1)
    l_cls = (per_anchor * valid).sum() / n_valid
    n_pos = nd.maximum(loc_m.sum() / 4.0, nd.array([1.0], ctx=ctx))
    l_loc = invoke("smooth_l1", [loc_f * loc_m - loc_t],
                   {"scalar": 1.0}).sum() / n_pos
    return (l_cls + l_loc) * per_dev


def build(args, ctx):
    """The net, initialized (Xavier) and probed once; and the parameters
    the example trains: those the probe gave a shape (the extra blocks a
    deep backbone does not need stay deferred)."""
    net = MultiScaleSSD(args.num_classes, backbone=args.backbone,
                        num_scales=args.num_scales, device=ctx)
    net.initialize(initializer.Xavier())
    net(nd.zeros((1, 3, args.img_size, args.img_size), ctx=ctx))
    params = {name: p for name, p in net.collect_params().items()
              if not p._deferred_init}
    return net, params


def main(argv=None):
    """The example's loop over ``--epochs`` of ``--iters`` synthetic
    batches, from weights seeded with 0 (the example's deterministic
    init)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--num-classes", type=int, default=3)
    ap.add_argument("--num-scales", type=int, default=3)
    ap.add_argument("--backbone", default="tiny",
                    help="'tiny' or a model-zoo name (e.g. vgg16)")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=0.002)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    ctx = resolve_device(args.device)

    mx_random.seed(0)
    net, params = build(args, ctx)
    opt_args = ({"learning_rate": args.lr, "momentum": 0.9}
                if args.optimizer == "sgd" else {"learning_rate": args.lr})
    trainer = gluon.Trainer(params, args.optimizer, opt_args)
    rng = np.random.RandomState(0)

    map_before = evaluate_map(net, np.random.RandomState(99), args,
                              args.eval_batches, ctx)
    print("mAP before training: %.4f" % map_before, flush=True)
    losses = []
    for epoch in range(args.epochs):
        total = 0.0
        for _ in range(args.iters):
            x_np, lab_np = synthetic_batch(rng, args.batch_size,
                                           args.img_size, args.num_classes)
            x = nd.array(x_np, ctx=ctx)
            lab = nd.array(lab_np, ctx=ctx)
            with autograd.record():
                anchors, cls_f, loc_f = net(x)
                loss = ssd_loss(anchors, cls_f, loc_f, lab, args.batch_size)
            loss.backward()
            trainer.step(args.batch_size)
            total += float(loss.asnumpy().sum())
        losses.append(total / (args.iters * args.batch_size))
        print("epoch %d loss %.4f" % (epoch, losses[-1]), flush=True)
    map_after = evaluate_map(net, np.random.RandomState(99), args,
                             args.eval_batches, ctx)
    print("mAP after training: %.4f (was %.4f)" % (map_after, map_before),
          flush=True)
    x_np, _ = synthetic_batch(rng, 2, args.img_size, args.num_classes)
    det = detect(net, nd.array(x_np, ctx=ctx), nms_threshold=0.5,
                 nms_topk=-1)
    kept = int((det.asnumpy()[:, :, 0] >= 0).sum())
    print("detections kept after NMS: %d" % kept)
    if kept == 0:
        raise AssertionError("NMS swallowed every box")
    return {"epoch_loss": losses, "map_before": map_before,
            "map_after": map_after, "kept": kept, "net": net}


if __name__ == "__main__":
    main(sys.argv[1:])
