"""Port parity for the Gluon losses (mxnet_tpu_torch/gluon/loss.py) against
the JAX reference on the CPU, mirroring tests/test_loss.py: L1Loss,
SigmoidBinaryCrossEntropyLoss (from logits and from sigmoid), KLDivLoss
(from log-probabilities and from logits), HuberLoss, HingeLoss,
SquaredHingeLoss, LogisticLoss (signed and binary labels), TripletLoss,
PoissonNLLLoss (from log-rates, from rates, with Stirling's term) and
CTCLoss (both layouts, with and without lengths),
each with and without a constructor `weight`, a `sample_weight` and
another `batch_axis`. Each case runs the same numpy inputs through both
packages: the loss and the gradient of its sum with respect to the
prediction, then the port's loss hybridized against its eager self.

Tolerances, float32: 1e-5 relative and absolute (the same elementwise
operations; the reductions sum in another order).
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _uniform(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _case(name):
    """(make(gluon.loss) -> loss, [pred, label, ...], sample_weight or
    None); pred first, the argument the gradient is taken for."""
    pred = _uniform(4, 3, 2, seed=1, lo=-2, hi=2)
    real = _uniform(4, 3, 2, seed=2, lo=-2, hi=2)
    prob = _uniform(4, 3, 2, seed=3, lo=0.05, hi=0.95)
    binary = (_uniform(4, 3, 2, seed=4) > 0).astype(np.float32)
    signed = 2 * binary - 1
    dist = np.exp(_uniform(4, 3, 2, seed=5))
    dist = (dist / dist.sum(-1, keepdims=True)).astype(np.float32)
    counts = np.random.RandomState(6).poisson(2.0, (4, 3, 2)).astype(
        np.float32)
    sw = _uniform(4, 1, 1, seed=7, lo=0, hi=2)
    sw_t = _uniform(1, 3, 1, seed=7, lo=0, hi=2)
    logp = np.log(_uniform(4, 3, 2, seed=8, lo=0.1, hi=1.0))
    return {
        "l1": (lambda L: L.L1Loss(), [pred, real], None),
        "l1_weighted": (lambda L: L.L1Loss(weight=0.5), [pred, real], sw),
        "l1_batch_axis1": (lambda L: L.L1Loss(batch_axis=1), [pred, real],
                           sw_t),
        "sigmoid_bce_logits": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                               [pred, binary], None),
        "sigmoid_bce_logits_weighted": (
            lambda L: L.SigmoidBCELoss(weight=2.0), [pred, binary], sw),
        "sigmoid_bce_from_sigmoid": (
            lambda L: L.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
            [prob, binary], None),
        "kldiv_log_probs": (lambda L: L.KLDivLoss(), [logp, dist], None),
        "kldiv_logits": (lambda L: L.KLDivLoss(from_logits=False, axis=-1),
                         [pred, dist], sw),
        "huber": (lambda L: L.HuberLoss(), [pred, real], None),
        "huber_rho": (lambda L: L.HuberLoss(rho=0.5, weight=1.5),
                      [pred, real], sw),
        "hinge": (lambda L: L.HingeLoss(), [pred, signed], None),
        "hinge_margin": (lambda L: L.HingeLoss(margin=2, batch_axis=1),
                         [pred, signed], sw_t),
        "squared_hinge": (lambda L: L.SquaredHingeLoss(), [pred, signed],
                          None),
        "squared_hinge_weighted": (lambda L: L.SquaredHingeLoss(weight=0.3),
                                   [pred, signed], sw),
        "logistic_signed": (lambda L: L.LogisticLoss(), [pred, signed],
                            None),
        "logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                            [pred, binary], sw),
        "triplet": (lambda L: L.TripletLoss(), [pred, real,
                                                _uniform(4, 3, 2, seed=9)],
                    None),
        "triplet_margin": (lambda L: L.TripletLoss(margin=3, weight=0.5),
                           [pred, real, _uniform(4, 3, 2, seed=9)],
                           sw.reshape(4)),
        "poisson_logits": (lambda L: L.PoissonNLLLoss(), [pred, counts],
                           None),
        "poisson_rates": (lambda L: L.PoissonNLLLoss(from_logits=False),
                          [prob * 3, counts], sw),
        "poisson_full": (lambda L: L.PoissonNLLLoss(compute_full=True),
                         [pred, counts], None),
    }[name]


CASES = ["l1", "l1_weighted", "l1_batch_axis1", "sigmoid_bce_logits",
         "sigmoid_bce_logits_weighted", "sigmoid_bce_from_sigmoid",
         "kldiv_log_probs", "kldiv_logits", "huber", "huber_rho", "hinge",
         "hinge_margin", "squared_hinge", "squared_hinge_weighted",
         "logistic_signed", "logistic_binary", "triplet", "triplet_margin",
         "poisson_logits", "poisson_rates", "poisson_full"]


def _run(pkg, fn, arrays, sw):
    """(loss, d sum(loss) / d pred) under record."""
    ins = [pkg.nd.array(a) for a in arrays]
    ins[0].attach_grad()
    extra = () if sw is None else (pkg.nd.array(sw),)
    with pkg.autograd.record():
        out = fn(*ins, *extra)
        total = out.sum()
    total.backward()
    return out.asnumpy(), ins[0].grad.asnumpy()


@pytest.mark.parametrize("name", CASES)
def test_loss_matches_reference(name):
    make, arrays, sw = _case(name)
    want = _run(mx, make(mx.gluon.loss), arrays, sw)
    got = _run(tmx, make(tmx.gluon.loss), arrays, sw)
    assert got[0].shape == want[0].shape
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[0], want[0], **_TOL)
    np.testing.assert_allclose(got[1], want[1], **_TOL)


@pytest.mark.parametrize("name", CASES)
def test_loss_hybridized_equals_eager(name):
    make, arrays, sw = _case(name)
    fn = make(tmx.gluon.loss)
    eager = _run(tmx, fn, arrays, sw)
    fn.hybridize()
    hybrid = _run(tmx, fn, arrays, sw)
    assert fn._cached_graph is not None
    for a, b in zip(hybrid, eager):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_loss_values_against_numpy():
    """A few losses against their textbook formulas (tests/test_loss.py's
    oracles), as a check independent of the reference."""
    pred, label = _uniform(4, 3, seed=1), _uniform(4, 3, seed=2)
    L = tmx.gluon.loss
    l1 = L.L1Loss()(tmx.nd.array(pred), tmx.nd.array(label)).asnumpy()
    np.testing.assert_allclose(l1, np.abs(pred - label).mean(1), **_TOL)
    y = (label > 0).astype(np.float32)
    bce = L.SigmoidBinaryCrossEntropyLoss()(
        tmx.nd.array(pred), tmx.nd.array(y)).asnumpy()
    p = 1 / (1 + np.exp(-pred))
    np.testing.assert_allclose(
        bce, (-(y * np.log(p) + (1 - y) * np.log(1 - p))).mean(1), **_TOL)
    err = np.abs(pred - label)
    huber = L.HuberLoss(rho=0.5)(tmx.nd.array(pred),
                                 tmx.nd.array(label)).asnumpy()
    np.testing.assert_allclose(huber, np.where(
        err < 0.5, err ** 2, err - 0.25).mean(1), **_TOL)
    hinge = L.HingeLoss()(tmx.nd.array(pred),
                          tmx.nd.array(np.sign(label))).asnumpy()
    np.testing.assert_allclose(
        hinge, np.maximum(0, 1 - pred * np.sign(label)).mean(1), **_TOL)


def test_poisson_full_finite_at_zero_targets():
    pred = _uniform(3, 4, seed=1)
    target = np.zeros((3, 4), np.float32)
    target[0, 0] = 5.0
    for pkg in (mx, tmx):
        out = pkg.gluon.loss.PoissonNLLLoss(compute_full=True)(
            pkg.nd.array(pred), pkg.nd.array(target)).asnumpy()
        assert np.isfinite(out).all()
    np.testing.assert_allclose(
        tmx.gluon.loss.PoissonNLLLoss(compute_full=True)(
            tmx.nd.array(pred), tmx.nd.array(target)).asnumpy(),
        mx.gluon.loss.PoissonNLLLoss(compute_full=True)(
            mx.nd.array(pred), mx.nd.array(target)).asnumpy(), **_TOL)


@pytest.mark.parametrize("layout,label_layout,lengths,weighted", [
    ("NTC", "NT", False, False), ("TNC", "TN", True, True),
    ("NTC", "TN", True, False), ("TNC", "NT", False, False)])
def test_ctc_loss_not_exported_yet(layout, label_layout, lengths, weighted):
    """CTCLoss (blank last, -1 padding) in both layouts, with and without
    lengths, a weight and a sample_weight: the per-sequence losses and the
    gradient of their sum against the reference's, and hybridized against
    eager. (Named when the port had no CTC op; it now holds the port's
    CTCLoss to the reference.)"""
    T, N, C = 10, 3, 5
    rs = np.random.RandomState(11)
    pred = rs.randn(N, T, C).astype(np.float32)
    label = -np.ones((N, 4), np.float32)
    for i, k in enumerate((4, 2, 3)):
        label[i, :k] = rs.randint(0, C - 1, k)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    extra = [np.array([10, 7, 8], np.float32),
             np.array([4, 2, 3], np.float32)] if lengths else []
    sw = rs.uniform(0, 2, (N,)).astype(np.float32) if weighted else None

    def run(pkg, hybridize=False):
        loss = pkg.gluon.loss.CTCLoss(layout=layout,
                                      label_layout=label_layout,
                                      weight=0.5 if weighted else None)
        if hybridize:
            loss.hybridize()
        x = pkg.nd.array(pred)
        x.attach_grad()
        args = [pkg.nd.array(a) for a in [label] + extra]
        if sw is not None:       # positional: after the two lengths
            args.append(pkg.nd.array(sw))
        with pkg.autograd.record():
            out = loss(x, *args)
        out.backward()
        return out.asnumpy(), x.grad.asnumpy()

    want, want_g = run(mx)
    got, got_g = run(tmx)
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, **_TOL)
    np.testing.assert_allclose(got_g, want_g, **_TOL)
    hyb, hyb_g = run(tmx, hybridize=True)
    np.testing.assert_allclose(hyb, got, **_TOL)
    np.testing.assert_allclose(hyb_g, got_g, **_TOL)
