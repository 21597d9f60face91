"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Only what the ported training path uses: the :class:`Loss` base,
:func:`_apply_weighting` and :class:`SoftmaxCrossEntropyLoss` (alias
``SoftmaxCELoss``).  A loss returns one value per sample: the mean over
every axis except ``batch_axis``.
"""
from __future__ import annotations

import numbers

import torch.nn.functional as F

from ..ops.reduce_ops import pick
from .block import Block

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """``loss * sample_weight`` (broadcast), then ``* weight`` (a number)."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, numbers.Number):
            raise TypeError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _mean_except(x, axis):
    """Mean over every axis but ``axis`` (MXNet's ``mean(exclude=True)``)."""
    axis %= x.dim()
    dims = [d for d in range(x.dim()) if d != axis]
    return x.mean(dim=dims) if dims else x


class Loss(Block):
    """Base of the losses: a scalar ``weight`` and the ``batch_axis`` the
    result keeps.  A ``Block``, so NDArray arguments give an NDArray
    loss."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)

    def forward(self, pred, label, sample_weight=None):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] per sample.

    ``sparse_label``: ``label`` holds class indices (any dtype) of
    ``pred``'s shape without ``axis``; otherwise it is a distribution of
    ``pred``'s size.  ``from_logits``: ``pred`` is already log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            # float labels are truncated and clipped to the axis, as
            # pick's default mode does
            loss = -pick(pred, label, self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
