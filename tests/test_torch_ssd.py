"""BASELINE config 4 on the port: SSDLite (mxnet_tpu_torch/models/ssd.py)
against the JAX reference on the CPU, and examples/train_ssd.py on the
port.

Twin nets (num_classes=2, 48x48 inputs, batch 4) share the reference's
Xavier weights through `gluon_params_from_numpy`. Held to the reference:
the anchors, class and box predictions of a training-mode forward; the
targets (MultiBoxTarget with hard-negative mining, `net.targets`) and
the detections (`net.detect`) computed by each package from the same
numpy predictions; and three Adam steps of examples/train_ssd.py's
`ssd_loss` through each package's `gluon.Trainer` (the reference's eager
loop, as the example runs it). The port's steps run with
MXNET_FUSED_BN_EPILOGUE=1 (the plain versions of K3a-d on the CPU, each
reached once a step for each of the net's five BatchNorms) and =0 (the
composite), both held to the reference. Then the example itself
(its default 12 epochs) through ImageDetIter with `mxnet_tpu` aliased to
the port.

Tolerances: predictions and the first loss 1e-5; the losses of later
steps 1e-4 (Adam turns float32 differences in the gradients into steps
of the learning rate's order); targets' masks and classes and the
detections' classes and scores exact, their boxes and loc targets 1e-5.
"""
import sys

import numpy as np
import pytest

import jax

import mxnet_tpu as mx
from mxnet_tpu.models.ssd import SSDLite as RefSSDLite

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import SSDLite, gluon_params_from_numpy
from mxnet_tpu_torch.ops import fused_bn

from chip_smoke import load_example

_BATCH, _HW, _CLASSES, _STEPS, _LR = 4, 48, 2, 3, 0.005
_REL = 1e-5
_STEP_REL = 1e-4
_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _batch():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (_BATCH, 3, _HW, _HW)).astype(np.float32)
    lab = -np.ones((_BATCH, 3, 5), np.float32)
    lab[:, 0] = [0, 0.1, 0.1, 0.5, 0.6]
    lab[:2, 1] = [1, 0.4, 0.3, 0.9, 0.8]
    lab[1, 2] = [1, 0.05, 0.6, 0.35, 0.95]
    return x, lab


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _train(pkg, net, example, x, lab, steps):
    """examples/train_ssd.py's step, `steps` times: the losses."""
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": _LR})
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            anchors, cls_preds, loc_preds = net(pkg.nd.array(x))
            loc_t, loc_m, cls_t = net.targets(anchors, pkg.nd.array(lab),
                                              cls_preds)
            loss = example.ssd_loss(cls_preds, loc_preds, loc_t, loc_m,
                                    cls_t)
        loss.backward()
        trainer.step(_BATCH)
        losses.append(float(loss.asnumpy()))
    return losses


@pytest.fixture(scope="module")
def ref():
    """The reference net's weights (numpy), its first training-mode
    forward, and its losses over three Adam steps."""
    np.random.seed(0)
    x, lab = _batch()
    with mx.name.NameManager():
        net = RefSSDLite(num_classes=_CLASSES)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(x))
    arrays = {n: np.asarray(p.data()._data)
              for n, p in net.collect_params().items()}
    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        with mx.autograd.record():
            outs = [o.asnumpy() for o in net(mx.nd.array(x))]
        losses = _train(mx, net, load_example("train_ssd.py", mx), x, lab,
                        _STEPS)
    return arrays, outs, losses


def _port_net(arrays):
    with tmx.name.NameManager():
        net = SSDLite(num_classes=_CLASSES)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((1, 3, _HW, _HW)))
    gluon_params_from_numpy(net, arrays)
    return net


def test_parameter_names_match_the_reference(ref):
    arrays = ref[0]
    with tmx.name.NameManager():
        net = SSDLite(num_classes=_CLASSES)
    assert list(net.collect_params().keys()) == list(arrays)
    assert sum(n.endswith("_gamma") for n in arrays) == 5


def test_forward_matches_the_reference(ref):
    arrays, want, _ = ref
    net = _port_net(arrays)
    x, _ = _batch()
    with tmx.autograd.record():
        got = [o.asnumpy() for o in net(tmx.nd.array(x))]
    A = (6 * 6 + 3 * 3 + 2 * 2) * 3      # 48 / 4 = 12, then 6, 3, 2
    assert want[0].shape == (1, A, 4)
    for g, w, what in zip(got, want, ("anchors", "cls_preds", "loc_preds")):
        assert g.shape == w.shape, what
        assert _rel_err(g, w) < _REL, what


def test_targets_and_detections_match_the_reference(ref):
    """From the reference's predictions (the same numpy arrays on both
    sides): the mined targets exactly; the detections within 1e-5, and
    from the same probabilities their classes and scores exactly."""
    arrays, (anchors, cls_preds, loc_preds), _ = ref
    _, lab = _batch()
    rnet = RefSSDLite(num_classes=_CLASSES)
    with tmx.name.NameManager():
        pnet = SSDLite(num_classes=_CLASSES)
    rt = [t.asnumpy() for t in rnet.targets(
        mx.nd.array(anchors), mx.nd.array(lab), mx.nd.array(cls_preds))]
    pt = [t.asnumpy() for t in pnet.targets(
        tmx.nd.array(anchors), tmx.nd.array(lab), tmx.nd.array(cls_preds))]
    np.testing.assert_allclose(pt[0], rt[0], rtol=_REL, atol=_REL)
    np.testing.assert_array_equal(pt[1], rt[1])
    np.testing.assert_array_equal(pt[2], rt[2])
    assert (rt[2] > 0).any() and (rt[2] == 0).any() and (rt[2] < 0).any()
    # net.detect: each package's softmax, then MultiBoxDetection
    rd = rnet.detect(mx.nd.array(cls_preds), mx.nd.array(loc_preds),
                     mx.nd.array(anchors)).asnumpy()
    pd = pnet.detect(tmx.nd.array(cls_preds), tmx.nd.array(loc_preds),
                     tmx.nd.array(anchors)).asnumpy()
    assert pd.shape == rd.shape == (_BATCH, anchors.shape[1], 6)
    np.testing.assert_allclose(pd, rd, rtol=_REL, atol=_REL)
    assert (rd[..., 0] >= 0).any()
    # the same probabilities on both sides: identical classes and scores
    probs = mx.nd.softmax(mx.nd.array(cls_preds), axis=1).asnumpy()
    rd = mx.nd.contrib.MultiBoxDetection(
        mx.nd.array(probs), mx.nd.array(loc_preds), mx.nd.array(anchors),
        nms_threshold=0.45).asnumpy()
    pd = tmx.nd.contrib.MultiBoxDetection(
        tmx.nd.array(probs), tmx.nd.array(loc_preds), tmx.nd.array(anchors),
        nms_threshold=0.45).asnumpy()
    np.testing.assert_array_equal(pd[..., :2], rd[..., :2])
    np.testing.assert_allclose(pd, rd, rtol=_REL, atol=_REL)


@pytest.mark.parametrize("flag", ["1", "0"])
def test_three_adam_steps_match_the_reference(ref, monkeypatch, flag):
    """The port's losses over three Adam steps of the example's loss,
    with the fused BatchNorm path (on the CPU, the plain versions of
    K3a-d: each called once a step for each of the five BatchNorms) and
    without it."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    calls = {}
    for k in _KERNELS:
        real = getattr(fused_bn, k)

        def counted(*a, _real=real, _k=k, **kw):
            calls[_k] = calls.get(_k, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(fused_bn, k, counted)
    arrays, _, want = ref
    net = _port_net(arrays)
    assert calls == {}                      # an eval forward fuses nothing
    x, lab = _batch()
    got = _train(tmx, net, load_example("train_ssd.py", tmx), x, lab,
                 _STEPS)
    assert got[0] == pytest.approx(want[0], rel=_REL)
    assert got == pytest.approx(want, rel=_STEP_REL)
    assert got[-1] < got[0]
    n = 5 * _STEPS if flag == "1" else 0
    assert calls == ({k: n for k in _KERNELS} if n else {})


def test_train_ssd_example_runs_on_the_port(capsys):
    """examples/train_ssd.py at its defaults (12 epochs of 64 synthetic
    JPEGs through ImageDetIter) on the port: the loss falls and the top
    detection's IoU is a number in [0, 1]."""
    module = load_example("train_ssd.py", tmx)
    assert module.SSDLite is SSDLite
    argv = sys.argv
    sys.argv = ["train_ssd.py"]
    try:
        tmx.random.seed(0)
        np.random.seed(0)
        module.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out.splitlines()
    losses = [float(line.split()[-1]) for line in out
              if line.startswith("epoch")]
    assert len(losses) == 12 and losses[-1] < losses[0]
    iou = float(out[-1].split()[-1])
    assert 0.0 <= iou <= 1.0
