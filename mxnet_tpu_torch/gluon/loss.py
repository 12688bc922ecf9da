"""Gluon losses (port of `mxnet_tpu/gluon/loss.py`): Loss, L2Loss, L1Loss,
SigmoidBinaryCrossEntropyLoss, SoftmaxCrossEntropyLoss, KLDivLoss,
CTCLoss, HuberLoss, HingeLoss, SquaredHingeLoss, LogisticLoss,
TripletLoss and PoissonNLLLoss, with the reference's shared scale-and-reduce pipeline:
each elementwise loss is a `_residual` of the prediction and the label
reshaped like it, weighted by `weight` and `sample_weight` and averaged
over every axis but `batch_axis`. The binary cross-entropy on logits is
softplus(z) - z * y, as the reference's. CTCLoss runs the CTC op with
the blank last, one loss a sequence.
"""
from __future__ import annotations

from .block import HybridBlock


def _like(F, x, ref):
    """`x` in `ref`'s shape (labels arrive rank-deficient); through the
    reshape_like op, so a traced loss takes the shape when it runs."""
    return F.reshape_like(x, ref)


def _scaled(F, loss, const_weight, sample_weight):
    """Fold the constructor weight and per-sample weights into `loss`."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    return loss if const_weight is None else loss * const_weight


def _logit_bce(F, z, y):
    """Stable binary cross-entropy on logits: softplus(z) - z * y."""
    return F.softrelu(z) - z * y


class Loss(HybridBlock):
    """Holds (weight, batch_axis) and the shared scale/reduce plumbing."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)

    def _finish(self, F, loss, sample_weight):
        loss = _scaled(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _MatchedLoss(Loss):
    """mean_over_non_batch(residual(pred, label_reshaped_like_pred))."""

    def _residual(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        return self._finish(
            F, self._residual(F, pred, _like(F, label, pred)), sample_weight)


class L2Loss(_MatchedLoss):
    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _residual(self, F, pred, label):
        return 0.5 * F.square(pred - label)


class L1Loss(_MatchedLoss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _residual(self, F, pred, label):
        return F.abs(pred - label)


class SigmoidBinaryCrossEntropyLoss(_MatchedLoss):
    """From logits (by default) or, with from_sigmoid, from
    probabilities (each log guarded by 1e-12)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _residual(self, F, pred, label):
        if self._from_sigmoid:
            eps = 1e-12
            return -label * F.log(pred + eps) \
                - (1. - label) * F.log(1. - pred + eps)
        return _logit_bce(F, pred, label)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -F.sum(logp * _like(F, label, logp), axis=self._axis,
                         keepdims=True)
        return self._finish(F, nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log(label) - pred), pred log-probabilities (from_logits,
    the default) or logits put through log_softmax over `axis`."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        div = label * (F.log(label + 1e-12) - logp)
        return self._finish(F, div, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification, blank = the last class:
    pred in `layout` NTC or TNC, label in `label_layout` NT or TN padded
    with -1, optional pred_lengths / label_lengths; [N] losses."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("layout must be NTC or TNC, got %r" % layout)
        if label_layout not in ("NT", "TN"):
            raise ValueError("label_layout must be NT or TN, got %r"
                             % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        # the op takes time-major activations and batch-major labels
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        per_seq = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                            use_data_lengths=pred_lengths is not None,
                            use_label_lengths=label_lengths is not None,
                            blank_label="last")
        return _scaled(F, per_seq, self._weight, sample_weight)


class HuberLoss(_MatchedLoss):
    """Quadratic, err^2 / (2 rho), inside |err| < rho; linear, |err| -
    rho / 2, outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _residual(self, F, pred, label):
        err = F.abs(pred - label)
        return F.where(err < self._rho,
                       (0.5 / self._rho) * F.square(err),
                       err - 0.5 * self._rho)


class HingeLoss(_MatchedLoss):
    """relu(margin - pred * label), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _residual(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    def _residual(self, F, pred, label):
        return F.square(super()._residual(F, pred, label))


class LogisticLoss(_MatchedLoss):
    """The binary cross-entropy on logits, labels "signed" ({-1, 1}) or
    "binary" ({0, 1})."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be signed or binary, got %r"
                             % label_format)
        self._label_format = label_format

    def _residual(self, F, pred, label):
        if self._label_format == "signed":
            label = 0.5 * (label + 1.)
        return _logit_bce(F, pred, label)


class TripletLoss(Loss):
    """relu(sum(|pred - positive|^2 - |pred - negative|^2) + margin), the
    sum over every axis but the batch's."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        gap = F.square(pred - _like(F, positive, pred)) \
            - F.square(pred - _like(F, negative, pred))
        gap = F.sum(gap, axis=self._batch_axis, exclude=True)
        return _scaled(F, F.relu(gap + self._margin), self._weight,
                       sample_weight)


class PoissonNLLLoss(Loss):
    """exp(pred) - target * pred from log-rates (from_logits, the
    default), else pred - target * log(pred + epsilon); compute_full adds
    Stirling's approximation of log(target!) where target > 1. Returns
    the mean over every element, as the reference does."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _like(F, target, pred)
        if self._from_logits:
            nll = F.exp(pred) - target * pred
        else:
            nll = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            # the clamp keeps log() finite at target 0 in the branch the
            # where drops (a multiply by a 0/1 mask would make it NaN)
            safe = F.maximum(target, 1.)
            stirling = target * F.log(safe) - target \
                + 0.5 * F.log(6.2831853 * safe)
            nll = nll + F.where(target > 1, stirling, stirling * 0.)
        return F.mean(_scaled(F, nll, self._weight, sample_weight))
