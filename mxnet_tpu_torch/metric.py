"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

Only what the training loop uses: :class:`EvalMetric`,
:func:`check_label_shapes` and :class:`Accuracy` (:242-261).  Labels and
predictions are lists of tensors, on any device; each update brings its
count of hits to the host.
"""
from __future__ import annotations

import torch

__all__ = ["EvalMetric", "Accuracy", "check_label_shapes"]


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless ``labels`` and ``preds`` have the same length (with
    ``shape``, the same shape); with ``wrap`` a bare tensor becomes a
    one-element list.  Returns (labels, preds)."""
    got = (labels.shape, preds.shape) if shape else (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(*got))
    if wrap:
        labels = [labels] if isinstance(labels, torch.Tensor) else labels
        preds = [preds] if isinstance(preds, torch.Tensor) else preds
    return labels, preds


class EvalMetric:
    """Base metric: ``sum_metric`` accumulated over ``num_inst``."""

    def __init__(self, name):
        self.name = str(name)
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        """(name, value); the value is nan before any update."""
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)


class Accuracy(EvalMetric):
    """Fraction of predictions equal to the label.  A prediction whose
    shape is not its label's is reduced by argmax over ``axis`` first;
    both are then cast to int32 (float labels truncate)."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if pred.shape != label.shape:
                pred = torch.argmax(pred, dim=self.axis)
            decided = pred.to(torch.int32).reshape(-1)
            truth = label.to(torch.int32).reshape(-1)
            check_label_shapes(truth, decided)
            self.sum_metric += int((decided == truth).sum())
            self.num_inst += decided.numel()
