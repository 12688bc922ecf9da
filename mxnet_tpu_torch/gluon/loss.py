"""Gluon losses of the ResNet path (port of the matching share of
`mxnet_tpu/gluon/loss.py`): Loss, L2Loss and SoftmaxCrossEntropyLoss, with
the reference's shared scale-and-reduce pipeline. The other losses are
not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from .block import HybridBlock


def _like(x, ref):
    """View `x` with `ref`'s geometry (labels arrive rank-deficient)."""
    return x.reshape(ref.shape)


def _scaled(F, loss, const_weight, sample_weight):
    """Fold the constructor weight and per-sample weights into `loss`."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    return loss if const_weight is None else loss * const_weight


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
            F, self._residual(F, pred, _like(label, pred)), sample_weight)


class L2Loss(_MatchedLoss):
    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _residual(self, F, pred, label):
        return 0.5 * F.square(pred - label)


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
            nll = -F.sum(logp * _like(label, logp), axis=self._axis,
                         keepdims=True)
        return self._finish(F, nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
