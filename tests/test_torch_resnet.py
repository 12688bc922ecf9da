"""Port parity for the model zoo's ResNets trained through TrainStep
(mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py, parallel/trainer.py)
against the JAX reference on the CPU, with MXNET_FUSED_BN_EPILOGUE on
(the reference's Pallas kernels in interpret mode, the port's plain
versions of K3a-d) and off (both compose BatchNorm from plain ops).

The step oracle is the reference's `functionalize(net, train_mode=True)`
called with an explicit PRNG key, under jax.value_and_grad of the mean
SoftmaxCrossEntropyLoss, with the reference's `optimizer_rules._sgd_apply`
on top: the reference TrainStep itself draws its key through a jax API
this jax lacks. The running-stat oracle is the reference's eager
`with autograd.record(): net(x)`. Weights cross over by name.

Size: resnet18_v1(classes=10), batch 2, 64x64 inputs. At 32x32 the last
stage's BatchNorms normalize over 2 values a channel (N x 1 x 1): the
variance is the square of half a difference, and the one-pass E[x^2] -
E[x]^2 rounding moves the loss by 1.6e-3 between the reference's own two
flag states; at 64x64 it is 8 values a channel and the loss moves by
1.4e-7 (tools/resnet_grad_probe.py --impl reference).
SGD at lr 0.01 (momentum 0.9, wd 1e-4): at lr 0.05 the batch of 2 is
memorized in one step and the next gradients are rounding noise.

Tolerances: logits and losses 1e-5 relative (float32 sums in another
order through 18 layers); gradients 2e-4 of each tensor's largest element
(the same sums, through the backward); the losses of the later steps
1e-4 relative and the parameters after three steps 2e-4 of each tensor's
largest element (the first step's gradient differences carried through
the momentum); running stats and eval logits 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import optimizer_rules as ref_rules
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.parallel.functional import functionalize

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as port_vision
from mxnet_tpu_torch.models import gluon_params_from_numpy
from mxnet_tpu_torch.ops import fused_bn
from mxnet_tpu_torch.parallel import TrainStep

torch.backends.cudnn.allow_tf32 = False

_BATCH, _HW, _CLASSES = 2, 64, 10
_LR, _MOMENTUM, _WD = 0.01, 0.9, 1e-4
_REL = 1e-5
_GRAD_REL = 2e-4
_STEP_REL = 1e-4
#: a conv bias that feeds a BatchNorm has a gradient of exactly zero (the
#: normalization removes any per-channel constant): both sides hold
#: float32 rounding noise there, held to this absolute bound instead
_ZERO_GRAD = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def nets():
    """The reference resnet18_v1 and the port's, with the same weights;
    the reference's arrays (running stats included) as numpy."""
    np.random.seed(0)
    with mx.name.NameManager():
        ref = ref_vision.resnet18_v1(classes=_CLASSES)
    ref.initialize(mx.init.Xavier())
    ref(mx.nd.zeros((1, 3, 32, 32)))
    with tmx.cpu(), tmx.name.NameManager():
        port = port_vision.resnet18_v1(classes=_CLASSES)
        port.initialize(tmx.init.Xavier())
        port(tmx.nd.zeros((1, 3, 32, 32)))
    arrays = {n: np.asarray(p.data()._data)
              for n, p in ref.collect_params().items()}
    return ref, port, arrays


def _batch():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (_BATCH, 3, _HW, _HW)).astype(np.float32)
    y = rng.randint(0, _CLASSES, (_BATCH,)).astype(np.int32)
    return x, y


def _rel_err(got, want):
    """max |got - want| over the tensor's largest |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _step_oracle(ref, x, y):
    """jit(value_and_grad) of the reference's mean loss over its
    parameter tuple; also returns the logits. Traced on first call, so
    the caller sets the flag first."""
    apply_fn, names, values = functionalize(ref, train_mode=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss(vals):
        out = apply_fn(vals, xj, key=jax.random.PRNGKey(0))
        return jnp.mean(loss_fn(mx.nd.NDArray(out),
                                mx.nd.NDArray(yj))._data), out

    return jax.jit(jax.value_and_grad(loss, has_aux=True)), names, values


def test_parameter_names_match_the_reference():
    """102 names for resnet18_v1 (`resnetv10_conv2d0_weight`, ...), and
    resnet50_v1's 53 BatchNorms' and every other name, in order."""
    for make in ("resnet18_v1", "resnet50_v1"):
        with mx.name.NameManager():
            ref = getattr(ref_vision, make)()
        with tmx.name.NameManager():
            port = port_vision.get_model(make)
        names = list(port.collect_params().keys())
        assert names == list(ref.collect_params().keys())
        assert names[0] == "resnetv10_conv2d0_weight"
        if make == "resnet18_v1":
            assert len(names) == 102
        else:
            assert sum(n.endswith("_gamma") for n in names) == 53


@pytest.mark.parametrize("flag", ["1", "0"])
def test_resnet18_step_matches_the_reference(nets, monkeypatch, flag):
    """The first step's logits, loss and every gradient, then three SGD
    steps through the port's TrainStep against the oracle's steps."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    ref, port, arrays = nets
    gluon_params_from_numpy(port, arrays)
    x, y = _batch()
    oracle, names, values = _step_oracle(ref, x, y)
    (jloss, jlogits), jgrads = oracle(values)

    with tmx.autograd.record():
        logits = port(tmx.nd.array(x))
    assert _rel_err(logits.asnumpy(), jlogits) < _REL
    gluon_params_from_numpy(port, arrays)        # undo the running stats
    step = TrainStep(port, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": _LR, "momentum": _MOMENTUM,
                      "wd": _WD})
    loss, grads = step.loss_and_grads(x, y)
    assert float(loss) == pytest.approx(float(jloss), rel=_REL)
    params = ref.collect_params()
    gmask = [params[n].grad_req != "null" for n in names]
    assert sorted(grads) == sorted(n for n, m in zip(names, gmask) if m)
    for n, g in zip(names, jgrads):
        if n in grads:
            assert _rel_err(grads[n].numpy(), g) < _GRAD_REL, n

    vals, states = list(values), {}
    hyper = {"momentum": _MOMENTUM}
    for t in range(1, 4):
        (jloss, _), jgrads = oracle(tuple(vals))
        got = float(step(x, y))
        assert got == pytest.approx(float(jloss), rel=_STEP_REL), t
        for i, m in enumerate(gmask):
            if m:
                state = states.setdefault(
                    i, ref_rules._sgd_init(vals[i], hyper))
                vals[i], states[i] = ref_rules._sgd_apply(
                    vals[i], jgrads[i], state, _LR, _WD, t, hyper)
    assert step.t == 3
    step.sync_params()
    pparams = port.collect_params()
    for n, v, m in zip(names, vals, gmask):
        if m:
            assert _rel_err(pparams[n].data().asnumpy(), v) < _GRAD_REL, n


@pytest.mark.parametrize("flag", ["1", "0"])
def test_resnet18_running_stats_and_eval_logits(nets, monkeypatch, flag):
    """One TrainStep writes the BatchNorm running stats the reference's
    eager training forward writes; then the eval-mode logits (moving
    stats) agree."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    ref, port, arrays = nets
    gluon_params_from_numpy(port, arrays)
    x, y = _batch()
    with mx.autograd.record():
        ref(mx.nd.array(x))
    after = {n: np.asarray(p.data()._data)
             for n, p in ref.collect_params().items()}
    # put the reference back as the module's fixture holds it
    for n, p in ref.collect_params().items():
        p.set_data(mx.nd.array(arrays[n]))
    step = TrainStep(port, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": _LR})
    step(x, y)
    pparams = port.collect_params()
    stats = [n for n in arrays if n.endswith(("running_mean",
                                              "running_var"))]
    assert len(stats) == 2 * 20
    for n in stats:
        assert not np.array_equal(after[n], arrays[n]), n
        assert _rel_err(pparams[n].data().asnumpy(), after[n]) < _REL, n
    # eval mode: both nets at the reference's moved stats
    gluon_params_from_numpy(port, after)
    for n, p in ref.collect_params().items():
        p.set_data(mx.nd.array(after[n]))
    try:
        want = np.asarray(ref(mx.nd.array(x))._data)
    finally:
        for n, p in ref.collect_params().items():
            p.set_data(mx.nd.array(arrays[n]))
    got = port(tmx.nd.array(x)).asnumpy()
    assert _rel_err(got, want) < _REL


@pytest.mark.parametrize("flag", ["1", "0"])
def test_bottleneck_v1_block_matches_the_reference(monkeypatch, flag):
    """ResNet-50's block type alone, with its downsample branch: output
    and the gradients of the input and every parameter."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    with mx.name.NameManager():
        ref = ref_vision.BottleneckV1(32, 2, downsample=True, in_channels=16)
    with tmx.name.NameManager():
        port = port_vision.BottleneckV1(32, 2, downsample=True,
                                        in_channels=16)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    ref(mx.nd.zeros((1, 16, 8, 8)))
    port(tmx.nd.zeros((1, 16, 8, 8)))
    gluon_params_from_numpy(port, {n: np.asarray(p.data()._data) for n, p in
                                   ref.collect_params().items()})
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 12, 12).astype(np.float32)
    w = rng.randn(2, 32, 6, 6).astype(np.float32)
    apply_fn, names, values = functionalize(ref, train_mode=True)

    def loss(vals, xj):
        out = apply_fn(vals, xj, key=jax.random.PRNGKey(0))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), (jgv, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(values, jnp.asarray(x))
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        out = port(xt)
        total = (out * tmx.nd.array(w)).sum()
    total.backward()
    assert _rel_err(out.asnumpy(), jout) < _REL
    assert _rel_err(xt.grad.asnumpy(), jgx) < _GRAD_REL
    pparams = port.collect_params()
    body_conv_biases = [n for n in names if "conv2d" in n
                        and n.endswith("_bias")]
    assert len(body_conv_biases) == 2
    for n, g in zip(names, jgv):
        if pparams[n].grad_req == "null":
            continue
        got = pparams[n].grad().asnumpy()
        if n in body_conv_biases:
            assert np.abs(got).max() < _ZERO_GRAD and \
                np.abs(np.asarray(g)).max() < _ZERO_GRAD, n
        else:
            assert _rel_err(got, g) < _GRAD_REL, n


@pytest.mark.parametrize("flag", ["1", "0"])
def test_resnet50_step_runs_each_fused_kernel_53_times(monkeypatch, flag):
    """With the flag on, a ResNet-50 v1 step reaches each of K3a-d once
    for each of its 53 BatchNorms (on the CPU, their plain versions);
    with the flag off, none. chip_smoke.py checks the card's launch
    counts against the same 53."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    calls = {}
    for k in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        real = getattr(fused_bn, k)

        def counted(*a, _real=real, _k=k, **kw):
            calls[_k] = calls.get(_k, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(fused_bn, k, counted)
    with tmx.name.NameManager():
        net = port_vision.resnet50_v1(classes=_CLASSES)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((1, 3, 32, 32)))
    assert calls == {}                       # an eval forward fuses nothing
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
    x, y = _batch()
    loss = step(x[:, :, :32, :32], y)
    assert np.isfinite(float(loss))
    want = 53 if flag == "1" else 0
    assert calls == ({k: want for k in ("bn_stats", "bn_apply",
                                        "bn_bwd_reduce", "bn_bwd_dx")}
                     if want else {})
