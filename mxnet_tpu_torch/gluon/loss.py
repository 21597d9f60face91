"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Every loss is a ``HybridBlock`` written, as the JAX package writes it, as
``hybrid_forward(F, pred, label, ...)``: called on tensors (or NDArrays)
``F`` is the registered ops over tensors
(``ndarray.register.tensor_ops``), so the loss is differentiated under
whatever grad mode the caller runs; called on Symbols it builds the JAX
package's graph.  A loss returns one value per sample: the mean over every
axis except ``batch_axis``.  :class:`Loss` takes ``prefix`` and ``params``
as a block does.

``CTCLoss`` calls the ``CTCLoss`` op (torch's ``ctc_loss``; a jnp scan in
the reference, not a Pallas kernel).
"""
from __future__ import annotations

from ..base import numeric_types
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """``loss * sample_weight`` (broadcast), then ``* weight`` (a number)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, numeric_types):
            raise TypeError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape) if hasattr(y, "shape") \
        else F.reshape_like(x, y)


class Loss(HybridBlock):
    """Base of the losses: a scalar ``weight`` and the ``batch_axis`` the
    result keeps."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (or, ``from_sigmoid``, of
    probabilities), with ``pos_weight`` scaling the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * \
                    (F.Activation(-F.abs(pred), act_type="softrelu")
                     + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] per sample.

    ``sparse_label``: ``label`` holds class indices (any dtype; floats are
    truncated and clipped to the axis, as ``pick`` does) of ``pred``'s
    shape without ``axis``; otherwise it is a distribution of ``pred``'s
    size.  ``from_logits``: ``pred`` is already log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class CTCLoss(Loss):
    """Connectionist temporal classification loss per sample, through the
    ``CTCLoss`` op with ``blank_label='last'`` (labels from 0, padding
    -1), as the reference's; ``pred_lengths``/``label_lengths`` are taken
    when given."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise AssertionError("layout must be NTC or TNC")
        if label_layout not in ("NT", "TN"):
            raise AssertionError("label_layout must be NT or TN")
        self._layout = layout
        self._label_layout = label_layout
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.transpose(pred, axes=(1, 0, 2))
        if self._label_layout == "TN":
            label = F.transpose(label, axes=(1, 0))
        lengths = [x for x in (pred_lengths, label_lengths) if x is not None]
        loss = F.CTCLoss(pred, label, *lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, None)
