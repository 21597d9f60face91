"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

:func:`create` and the registry (:27-45, :159), :class:`EvalMetric`,
:class:`CompositeEvalMetric` (:195), the ``_ScalarMetric`` family
(:137-160): :class:`Accuracy`, :class:`TopKAccuracy`, :class:`MAE`,
:class:`MSE`, :class:`RMSE`, :class:`CrossEntropy`,
:class:`NegativeLogLikelihood`; :class:`Perplexity` (:444-498),
:class:`Loss` (:596-619), :class:`F1`, and the detection metrics
:class:`VOCMApMetric` (:648) and :class:`VOC07MApMetric` (:777).

Labels and predictions are lists of tensors or NDArrays on any device.
``update`` computes a batch's statistic on the arrays' device and brings it
to the host with one ``Tensor.item()`` a statistic.  Each metric but F1
and the mAP metrics also has a device twin, ``traced_update(labels,
preds) -> (stat, count)`` (:104-117): 0-d fp32 tensors, with no host
fetch, which the compiled train step (``module/compiled_step.py``) adds
into accumulators on the card and fetches only at ``metric_interval``
boundaries.  F1 has none, so a compiled fit with it falls back to the
eager loop, as in the JAX package.
"""
from __future__ import annotations

import math
import threading

import numpy
import torch

from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Loss", "VOCMApMetric", "VOC07MApMetric",
           "check_label_shapes", "create", "register"]

_METRIC_REGISTRY = {}
_METRIC_REGISTRY_LOCK = threading.Lock()


def register(klass):
    """Register a metric class under its lowercased class name."""
    with _METRIC_REGISTRY_LOCK:
        _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*aliases):
    def deco(klass):
        register(klass)
        with _METRIC_REGISTRY_LOCK:
            _METRIC_REGISTRY.update({a.lower(): klass for a in aliases})
        return klass
    return deco


def _t(x):
    return x._data.detach() if isinstance(x, NDArray) else x.detach()


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless ``labels`` and ``preds`` have the same length (with
    ``shape``, the same shape); with ``wrap`` a bare array becomes a
    one-element list.  Returns (labels, preds)."""
    got = (labels.shape, preds.shape) if shape else (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(*got))
    if wrap:
        if isinstance(labels, (torch.Tensor, NDArray)):
            labels = [labels]
        if isinstance(preds, (torch.Tensor, NDArray)):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric: ``sum_metric`` accumulated over ``num_inst``."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name, self._kwargs = str(name), kwargs
        self.output_names, self.label_names = output_names, label_names
        self.reset()

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())

    def update(self, labels, preds):
        raise NotImplementedError()

    # the device twin: (stat, count) of one batch as 0-d fp32 tensors on
    # the arrays' device; None means none (a compiled fit falls back)
    traced_update = None

    def supports_device_update(self):
        return callable(getattr(self, "traced_update", None))

    def _device_accumulate(self, stat, count):
        """Fold a fetched (stat, count) of the device accumulators in."""
        self.sum_metric += float(stat)
        self.num_inst += int(round(float(count)))

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        """(name, value); the value is nan before any update."""
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


class _ScalarMetric(EvalMetric):
    """A metric defined by one statistic per (label, pred) pair:
    ``_batch_stat(label, pred) -> (stat tensor, count)`` on tensors, which
    ``update`` fetches and ``traced_update`` keeps on the device."""

    def _batch_stat(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            stat, count = self._batch_stat(_t(label).to(pred.device), pred)
            self.sum_metric += stat.item()
            self.num_inst += int(count)

    def traced_update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("Shape of labels %d does not match shape of "
                             "predictions %d" % (len(labels), len(preds)))
        stat = count = None
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            s, c = self._batch_stat(_t(label).to(pred.device), pred)
            s = s.to(torch.float32)
            stat = s if stat is None else stat + s
            count = float(c) if count is None else count + float(c)
        # a fill on the device: a host-made tensor would be a copy, which
        # a graph capture cannot hold
        return stat, stat.new_full((), count)


def create(metric, *args, **kwargs):
    """A metric from a name (``"acc"``, ``"ce"``), an instance, or a list
    of them (a :class:`CompositeEvalMetric`)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, *args, **kwargs))
        return out
    if isinstance(metric, str):
        klass = _METRIC_REGISTRY.get(metric.lower())
        if klass is not None:
            return klass(*args, **kwargs)
    raise ValueError("metric %s not recognized" % metric)


@register
class CompositeEvalMetric(EvalMetric):
    """Fan updates out to child metrics; report all their values."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}"
                              .format(index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names += name if isinstance(name, list) else [name]
            values += value if isinstance(value, list) else [value]
        return (names, values)


@_alias("acc")
class Accuracy(_ScalarMetric):
    """Fraction of predictions equal to the label.  A prediction whose
    shape is not its label's is reduced by argmax over ``axis`` first;
    both are then cast to int32 (float labels truncate)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _batch_stat(self, label, pred):
        if pred.shape != label.shape:
            pred = torch.argmax(pred, dim=self.axis)
        decided = pred.to(torch.int32).reshape(-1)
        truth = label.to(torch.int32).reshape(-1)
        check_label_shapes(truth, decided)
        return (decided == truth).sum(), decided.numel()


@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(_ScalarMetric):
    """Fraction of samples whose label is among the ``top_k`` scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        if top_k <= 1:
            raise AssertionError("Please use Accuracy if top_k is no more "
                                 "than 1")
        self.top_k = top_k
        self.name = "%s_%d" % (self.name, top_k)

    def _batch_stat(self, label, pred):
        if pred.dim() == 1:
            return (pred.long() == label.long()).sum(), label.shape[0]
        if pred.dim() != 2:
            raise AssertionError("Predictions should be no more than 2 dims")
        k = min(self.top_k, pred.shape[1])
        top = torch.topk(pred.float(), k, dim=1).indices
        member = (top == label.long()[:, None]).any(dim=1)
        return member.sum(), label.shape[0]


def _as_2d(a):
    return a[:, None] if a.dim() == 1 else a


@register
class MAE(_ScalarMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _batch_stat(self, label, pred):
        return (_as_2d(label) - _as_2d(pred)).abs().mean(), 1


@register
class MSE(_ScalarMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _batch_stat(self, label, pred):
        return (_as_2d(label) - _as_2d(pred)).square().mean(), 1


@register
class RMSE(_ScalarMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _batch_stat(self, label, pred):
        return (_as_2d(label) - _as_2d(pred)).square().mean().sqrt(), 1


class _LabelProbMetric(_ScalarMetric):
    """CrossEntropy and NegativeLogLikelihood: the sum of
    ``-log(p(label) + eps)`` over the batch."""

    def __init__(self, eps, name, output_names, label_names):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _batch_stat(self, label, pred):
        idx = label.reshape(-1).long()
        if idx.shape[0] != pred.shape[0]:
            raise AssertionError((idx.shape[0], pred.shape[0]))
        p_label = pred.gather(1, idx[:, None])[:, 0]
        return -(p_label + self.eps).log().sum(), pred.shape[0]


@_alias("ce")
class CrossEntropy(_LabelProbMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@_alias("nll_loss")
class NegativeLogLikelihood(_LabelProbMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    """exp(mean negative log predicted probability of the label), labels
    equal to ``ignore_label`` left out."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def _stat(self, label, pred):
        label, pred = _t(label), _t(pred)
        if label.numel() != pred.numel() // pred.shape[-1]:
            raise AssertionError("shape mismatch: %s vs. %s"
                                 % (tuple(label.shape), tuple(pred.shape)))
        flat = label.to(pred.device).reshape(-1).long()
        picked = pred.reshape(-1, pred.shape[-1]).gather(
            self.axis, flat[:, None])[:, 0]
        keep = torch.ones_like(picked, dtype=torch.bool) \
            if self.ignore_label is None else flat != int(self.ignore_label)
        stat = -torch.where(keep, picked.clamp_min(1e-10).log(),
                            torch.zeros_like(picked)).sum()
        return stat.to(torch.float32), keep.sum().to(torch.float32)

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        for label, pred in zip(labels, preds):
            stat, count = self._stat(label, pred)
            self.sum_metric += stat.item()
            self.num_inst += int(count.item())

    def traced_update(self, labels, preds):
        stat = count = None
        for label, pred in zip(labels, preds):
            s, c = self._stat(label, pred)
            stat = s if stat is None else stat + s
            count = c if count is None else count + c
        return stat, count

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class Loss(EvalMetric):
    """Mean of raw loss outputs (no labels consumed)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, (torch.Tensor, NDArray)):
            preds = [preds]
        for pred in preds:
            pred = _t(pred)
            self.sum_metric += pred.sum().item()
            self.num_inst += pred.numel()

    def traced_update(self, labels, preds):
        stat, count = None, 0.0
        for pred in preds:
            s = _t(pred).sum().to(torch.float32)
            stat = s if stat is None else stat + s
            count += float(_t(pred).numel())
        return stat, stat.new_full((), count)


@register
class F1(EvalMetric):
    """F1 of binary predictions (argmax over axis 1), averaged over the
    batches (``average='macro'``) or over the pooled counts (``'micro'``).
    Host-side only: no device twin."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._counts = dict.fromkeys(("tp", "fp", "fn", "tn"), 0)
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _fscore(self):
        c = self._counts
        p = c["tp"] / (c["tp"] + c["fp"]) if c["tp"] + c["fp"] else 0.0
        r = c["tp"] / (c["tp"] + c["fn"]) if c["tp"] + c["fn"] else 0.0
        return 2.0 * p * r / (p + r) if p + r else 0.0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            truth = _t(label).cpu().numpy().astype("int32").ravel()
            decided = numpy.argmax(_t(pred).float().cpu().numpy(), axis=1)
            check_label_shapes(truth, decided)
            if numpy.unique(truth).size > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            pos_pred, pos_true = decided == 1, truth == 1
            self._counts["tp"] += int((pos_pred & pos_true).sum())
            self._counts["fp"] += int((pos_pred & ~pos_true).sum())
            self._counts["fn"] += int((~pos_pred & pos_true).sum())
            self._counts["tn"] += int((~pos_pred & ~pos_true).sum())
        score = self._fscore()
        if self.average == "macro":
            self.sum_metric += score
            self.num_inst += 1
            self._counts = dict.fromkeys(self._counts, 0)
        else:
            n = sum(self._counts.values())
            self.sum_metric, self.num_inst = score * n, n

    def reset(self):
        self.sum_metric, self.num_inst = 0.0, 0
        if hasattr(self, "_counts"):
            self._counts = dict.fromkeys(self._counts, 0)


def _box_iou_one_to_many(box, boxes):
    """IoU of one [xmin, ymin, xmax, ymax] box against an (n, 4) array."""
    ix = numpy.maximum(0.0, numpy.minimum(boxes[:, 2], box[2])
                       - numpy.maximum(boxes[:, 0], box[0]))
    iy = numpy.maximum(0.0, numpy.minimum(boxes[:, 3], box[3])
                       - numpy.maximum(boxes[:, 1], box[1]))
    inter = ix * iy
    union = ((box[2] - box[0]) * (box[3] - box[1])
             + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
             - inter)
    return numpy.where(union > 1e-12, inter / numpy.maximum(union, 1e-12),
                       0.0)


def _host(x):
    return numpy.asarray(_t(x).float().cpu().numpy()
                         if isinstance(x, (torch.Tensor, NDArray)) else x)


@_alias("voc_map", "mAP")
class VOCMApMetric(EvalMetric):
    """Mean average precision for detection (:648-775; example/ssd's
    MApMetric semantics).  Host-side only: no device twin.

    ``update(labels, preds)`` takes one batch: ``labels[0]`` (B, M, 5|6)
    ground truths [cls, xmin, ymin, xmax, ymax, (difficult)], rows with
    cls < 0 padding; ``preds[pred_idx]`` (B, N, 6) detections [cls, score,
    xmin, ymin, xmax, ymax], rows with cls < 0 discarded (the
    ``_contrib_MultiBoxDetection`` format).  Per class, detections match
    ground truths score-descending at ``ovp_thresh`` IoU: the best-overlap
    unmatched one is a true positive, a second match or a sub-threshold
    overlap a false positive, a ``difficult`` one neither (unless
    ``use_difficult``).  AP is the area under the interpolated precision
    envelope; with ``class_names``, ``get`` gives each class's AP and the
    mean."""

    def __init__(self, ovp_thresh=0.5, use_difficult=False, class_names=None,
                 pred_idx=0, name="mAP"):
        self.ovp_thresh = float(ovp_thresh)
        self.use_difficult = bool(use_difficult)
        self.class_names = list(class_names) if class_names else None
        self.pred_idx = int(pred_idx)
        super().__init__(name, ovp_thresh=ovp_thresh,
                         use_difficult=use_difficult,
                         class_names=class_names, pred_idx=pred_idx)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        # per class: (score, is_tp) match records, and the gt count
        self._records = {}
        self._gt_counts = {}

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for label, pred in zip(_host(labels[0]), _host(preds[self.pred_idx])):
            self._update_image(label[label[:, 0] >= 0],
                               pred[pred[:, 0] >= 0])

    def _update_image(self, gts, dets):
        classes = set(numpy.unique(gts[:, 0]).astype(int))
        classes.update(numpy.unique(dets[:, 0]).astype(int))
        for cid in sorted(classes):
            recs = self._records.setdefault(cid, [])
            self._gt_counts.setdefault(cid, 0)
            g = gts[gts[:, 0].astype(int) == cid]
            difficult = (g[:, 5] > 0 if g.shape[1] >= 6
                         else numpy.zeros(len(g), bool))
            if self.use_difficult:
                difficult = numpy.zeros(len(g), bool)
            self._gt_counts[cid] += int((~difficult).sum())
            d = dets[dets[:, 0].astype(int) == cid]
            d = d[d[:, 1].argsort()[::-1]]
            taken = numpy.zeros(len(g), bool)
            for det in d:
                if len(g) == 0:
                    recs.append((float(det[1]), False))
                    continue
                ious = _box_iou_one_to_many(det[2:6], g[:, 1:5])
                best = int(ious.argmax())
                if ious[best] > self.ovp_thresh:
                    if difficult[best]:
                        continue   # neither a true nor a false positive
                    recs.append((float(det[1]), not taken[best]))
                    taken[best] = True
                else:
                    recs.append((float(det[1]), False))

    def _average_precision(self, recall, precision):
        """Area under the interpolated precision-recall envelope."""
        r = numpy.concatenate(([0.0], recall, [1.0]))
        p = numpy.concatenate(([0.0], precision, [0.0]))
        p = numpy.maximum.accumulate(p[::-1])[::-1]
        steps = numpy.nonzero(r[1:] != r[:-1])[0]
        return float(numpy.sum((r[steps + 1] - r[steps]) * p[steps + 1]))

    def _class_ap(self, cid):
        recs, count = self._records[cid], self._gt_counts[cid]
        if not recs and count == 0:
            return None   # only difficult gts and no detection: not counted
        if not recs:
            return 0.0
        order = sorted(recs, key=lambda r: -r[0])
        flags = numpy.array([r[1] for r in order], dtype=float)
        tp = numpy.cumsum(flags)
        fp = numpy.cumsum(1.0 - flags)
        recall = tp / count if count > 0 else tp * 0.0
        precision = tp / numpy.maximum(tp + fp, 1e-12)
        return self._average_precision(recall, precision)

    def get(self):
        aps = {cid: ap for cid in sorted(self._records)
               for ap in [self._class_ap(cid)] if ap is not None}
        mean = float(numpy.mean(list(aps.values()))) if aps else float("nan")
        if self.class_names is None:
            return (self.name, mean)
        names = list(self.class_names) + [self.name]
        values = [aps.get(i, float("nan"))
                  for i in range(len(self.class_names))] + [mean]
        return (names, values)


@_alias("voc07_map")
class VOC07MApMetric(VOCMApMetric):
    """PASCAL VOC-07's 11-point interpolated AP (:777-789)."""

    def _average_precision(self, recall, precision):
        ap = 0.0
        for t in numpy.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            ap += (float(precision[mask].max()) if mask.any() else 0.0) / 11.0
        return ap
