"""Port parity for the imperative framework core (mxnet_tpu_torch: NDArray,
autograd, the initializers, Gluon's Parameter / Block / layers / losses,
the SGD optimizer and its rule, the contexts) against the JAX reference
on the CPU.

Each net is built once in each package under a fresh NameManager, so the
two get the same parameter names; the reference's weights cross over by
name (`models.gluon_params_from_numpy`). Inputs are numpy arrays from a
seed. The port runs on the CPU (`with tmx.cpu():`): its default context is
the card.

Tolerances: elementwise arithmetic, shape ops, pooling and the SGD rule
are exact or within 1e-6 (the same float32 operations); matrix products,
convolutions and BatchNorm statistics 1e-5 (sums in another order), their
gradients 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import optimizer_rules as ref_rules

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer_rules as port_rules
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import gluon_params_from_numpy
from mxnet_tpu_torch.parallel import TrainStep

torch.backends.cudnn.allow_tf32 = False

_EXACT = dict(rtol=1e-6, atol=1e-6)
_FWD = dict(rtol=1e-5, atol=1e-5)
_GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _twin(make, *probe_shapes):
    """(reference net, port net) from `make(package)`, built under fresh
    name managers, initialized, materialized by one forward of zeros per
    input shape, and the port's weights set from the reference's."""
    with mx.name.NameManager():
        ref = make(mx)
    with tmx.name.NameManager():
        port = make(tmx)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    ref(*(mx.nd.zeros(s) for s in probe_shapes))
    port(*(tmx.nd.zeros(s) for s in probe_shapes))
    assert list(port.collect_params().keys()) == \
        list(ref.collect_params().keys())
    gluon_params_from_numpy(port, {n: np.asarray(p.data()._data) for n, p in
                                   ref.collect_params().items()})
    return ref, port


def _close(port_nd, ref_nd, **tol):
    np.testing.assert_allclose(port_nd.asnumpy(), np.asarray(ref_nd._data),
                               **tol)


# ---------------------------------------------------------------------------
# NDArray and the generated op namespace
# ---------------------------------------------------------------------------


_BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "radd": lambda a, b: 2.5 + a, "rsub": lambda a, b: 1.5 - a,
    "rdiv": lambda a, b: 3.0 / b, "pow": lambda a, b: abs(a) ** 1.5,
    "neg": lambda a, b: -a, "scalar_mul": lambda a, b: a * 0.25,
    "bcast": lambda a, b: a + b[0:1], "gt": lambda a, b: a > b,
    "le_scalar": lambda a, b: a <= 0.1, "eq": lambda a, b: a == a,
}


@pytest.mark.parametrize("op", sorted(_BINARY))
def test_ndarray_arithmetic_matches_reference(op):
    a, b = _rand(3, 4), _rand(3, 4, seed=1) + 3.0
    want = _BINARY[op](mx.nd.array(a), mx.nd.array(b))
    got = _BINARY[op](tmx.nd.array(a), tmx.nd.array(b))
    assert got.shape == want.shape
    assert got.dtype == np.dtype(want.dtype)
    _close(got, want, **_EXACT)


_UNARY = {
    "sum_axis": lambda F, x: F.sum(x, axis=1),
    "mean_exclude": lambda F, x: F.mean(x, axis=0, exclude=True),
    "max_keepdims": lambda F, x: F.max(x, axis=(1, 2), keepdims=True),
    "mean_all": lambda F, x: F.mean(x),
    "reshape_codes": lambda F, x: F.reshape(x, shape=(0, -1)),
    "reshape_m3": lambda F, x: F.reshape(x, shape=(-3, 0)),
    "reshape_m4": lambda F, x: F.reshape(x, shape=(-4, 1, 2, -2)),
    "flatten": lambda F, x: F.Flatten(x),
    "transpose": lambda F, x: F.transpose(x, axes=(2, 0, 1)),
    "expand_squeeze": lambda F, x: F.squeeze(F.expand_dims(x, axis=1),
                                             axis=1),
    "log_softmax": lambda F, x: F.log_softmax(x, axis=-1),
    "softmax": lambda F, x: F.softmax(x, axis=1),
    "relu": lambda F, x: F.Activation(x, act_type="relu"),
    "sigmoid": lambda F, x: F.Activation(x, act_type="sigmoid"),
    "clip": lambda F, x: F.clip(x, a_min=-0.5, a_max=0.5),
    "avg_pool_full": lambda F, x: F.Pooling(
        x, kernel=(3,), stride=(2,), pool_type="avg",
        pooling_convention="full", count_include_pad=False),
    "lp_pool_pad": lambda F, x: F.Pooling(
        x, kernel=(2,), pad=(1,), pool_type="lp", p_value=3),
    "global_max": lambda F, x: F.Pooling(x, pool_type="max",
                                         global_pool=True),
    "cast": lambda F, x: F.Cast(x, dtype="float16"),
}


@pytest.mark.parametrize("op", sorted(_UNARY))
def test_nd_ops_match_reference(op):
    x = _rand(2, 3, 4)
    want = _UNARY[op](mx.nd, mx.nd.array(x))
    got = _UNARY[op](tmx.nd, tmx.nd.array(x))
    assert got.shape == want.shape
    _close(got, want, **_EXACT)


def test_pick_and_ndarray_basics():
    x = _rand(4, 5)
    idx = np.array([0, 4, 2, 7], np.float32)       # 7 clips to 4
    want = mx.nd.pick(mx.nd.array(x), mx.nd.array(idx), axis=-1)
    got = tmx.nd.pick(tmx.nd.array(x), tmx.nd.array(idx), axis=-1)
    _close(got, want, **_EXACT)
    a = tmx.nd.array(x)
    assert a.context == tmx.cpu() and a.shape == (4, 5) and a.size == 20
    assert a.astype("bfloat16").dtype == torch.bfloat16
    assert float(a[1, 2].asscalar()) == pytest.approx(float(x[1, 2]))
    b = a.copy()
    b += 1.0
    np.testing.assert_allclose(b.asnumpy(), x + 1.0, **_EXACT)
    np.testing.assert_array_equal(a.asnumpy(), x)
    np.testing.assert_allclose(a.sum(axis=0).asnumpy(), x.sum(0), rtol=1e-6)
    z = tmx.nd.zeros((2, 3), dtype="int32")
    assert z.dtype == np.int32 and float(tmx.nd.ones((2,)).sum()) == 2.0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu"))
        net.add(pkg.gluon.nn.Dense(5, in_units=16))
    return net


def test_record_backward_matches_reference():
    """Gradients of a small net's parameters and input through
    autograd.record / backward, against the reference's tape."""
    ref, port = _twin(_mlp, (1, 7))
    x = _rand(3, 7)
    outs = {}
    for pkg, net in ((mx, ref), (tmx, port)):
        xv = pkg.nd.array(x)
        xv.attach_grad()
        with pkg.autograd.record():
            assert pkg.autograd.is_recording() and pkg.autograd.is_training()
            y = net(xv)
            loss = (y * y).sum() + pkg.nd.sum(pkg.nd.relu(xv))
        assert not pkg.autograd.is_recording()
        loss.backward()
        outs[pkg] = (y, xv.grad, {n: p.grad() for n, p in
                                  net.collect_params().items()})
    _close(outs[tmx][0], outs[mx][0], **_FWD)
    _close(outs[tmx][1], outs[mx][1], **_GRAD)
    for n, g in outs[mx][2].items():
        _close(outs[tmx][2][n], g, err_msg=n, **_GRAD)


def test_grad_req_add_accumulates_and_grad_leaves_buffers():
    x = _rand(2, 3)
    res = {}
    for pkg in (mx, tmx):
        v = pkg.nd.array(x)
        v.attach_grad(grad_req="add")
        for _ in range(2):
            with pkg.autograd.record():
                y = (v * v * 3.0).sum()
            y.backward()
        w = pkg.nd.array(x)
        w.attach_grad()
        with pkg.autograd.record():
            z = pkg.nd.exp(w).sum()
        (gw,) = pkg.autograd.grad(z, [w])
        res[pkg] = (v.grad, gw, w.grad)
    _close(res[tmx][0], res[mx][0], **_EXACT)
    np.testing.assert_allclose(res[tmx][0].asnumpy(), 12 * x, rtol=1e-6)
    _close(res[tmx][1], res[mx][1], **_FWD)
    np.testing.assert_array_equal(res[tmx][2].asnumpy(), 0.0)


def test_scopes_set_the_flags():
    ag = tmx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    with ag.train_mode():
        assert not ag.is_recording() and ag.is_training()
    with ag._RecordingStateScope(False, True):
        assert not ag.is_recording() and ag.is_training()
    assert not ag.is_recording() and not ag.is_training()
    with pytest.raises(MXNetError, match="record"):
        tmx.nd.ones((2,)).backward()


# ---------------------------------------------------------------------------
# Gluon layers, parameters, losses
# ---------------------------------------------------------------------------


def _convnet(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(6, kernel_size=3, strides=2, padding=1))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        net.add(nn.Conv2D(4, kernel_size=(1, 3), use_bias=False))
        net.add(nn.MaxPool2D(pool_size=2, ceil_mode=True))
        net.add(nn.GlobalAvgPool2D())
        net.add(nn.Flatten())
        net.add(nn.Dense(3))
    return net


@pytest.mark.parametrize("train", [False, True])
def test_layers_forward_and_grads_match_reference(train):
    """Conv2D (stride, padding, bias or not), BatchNorm, MaxPool2D (padded,
    and in ceil mode), GlobalAvgPool2D, Flatten and Dense, with deferred
    shapes; the parameter grads under record in training mode."""
    ref, port = _twin(_convnet, (1, 3, 13, 11))
    x = _rand(2, 3, 13, 11, seed=3)
    if not train:
        _close(port(tmx.nd.array(x)), ref(mx.nd.array(x)), **_FWD)
        return
    outs = {}
    for pkg, net in ((mx, ref), (tmx, port)):
        with pkg.autograd.record():
            y = net(pkg.nd.array(x))
            loss = (y * y).sum()
        loss.backward()
        outs[pkg] = (y, {n: p for n, p in net.collect_params().items()})
    _close(outs[tmx][0], outs[mx][0], **_FWD)
    for n, p in outs[mx][1].items():
        q = outs[tmx][1][n]
        assert q.grad_req == p.grad_req, n
        if p.grad_req != "null":
            _close(q.grad(), p.grad(), err_msg=n, **_GRAD)
        else:   # BatchNorm's running stats, moved by the training forward
            _close(q.data(), p.data(), err_msg=n, **_FWD)


def test_parameters_names_shapes_and_deferred_init():
    with tmx.name.NameManager():
        net = _convnet(tmx)
    names = list(net.collect_params().keys())
    assert names[:6] == ["hybridsequential0_conv2d0_weight",
                         "hybridsequential0_conv2d0_bias",
                         "hybridsequential0_batchnorm0_gamma",
                         "hybridsequential0_batchnorm0_beta",
                         "hybridsequential0_batchnorm0_running_mean",
                         "hybridsequential0_batchnorm0_running_var"]
    net.initialize()
    p = net.collect_params()["hybridsequential0_conv2d0_weight"]
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        p.data()
    net(tmx.nd.zeros((1, 3, 9, 9)))
    assert p.shape == (6, 3, 3, 3) and p.data().shape == (6, 3, 3, 3)
    mean = net.collect_params()["hybridsequential0_batchnorm0_running_mean"]
    assert mean._is_aux and mean.grad_req == "null"
    dense_w = net.collect_params()["hybridsequential0_dense0_weight"]
    assert dense_w.shape == (3, 4)
    net.hybridize()                      # runs the traced graph
    assert net._cached_graph is None
    assert net(tmx.nd.zeros((2, 3, 9, 9))).shape == (2, 3)
    assert net._cached_graph is not None
    with pytest.raises(MXNetError, match="missing"):
        gluon_params_from_numpy(net, {})
    arrays = {n: q.data().asnumpy() for n, q in net.collect_params().items()}
    arrays["hybridsequential0_dense0_weight"] = np.zeros((3, 5), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        gluon_params_from_numpy(net, arrays)
    arrays["extra"] = np.zeros(1)
    with pytest.raises(MXNetError, match="unexpected"):
        gluon_params_from_numpy(net, arrays)


@pytest.mark.parametrize("case", ["sparse", "dense", "weighted", "l2"])
def test_losses_match_reference(case):
    pred = _rand(4, 6, seed=5)
    sparse = np.array([1, 5, 0, 3], np.float32)
    dense = np.abs(_rand(4, 6, seed=6))
    w = np.array([[1.0], [0.5], [0.0], [2.0]], np.float32)
    res = {}
    for pkg in (mx, tmx):
        L = pkg.gluon.loss
        if case == "l2":
            fn, label, extra = L.L2Loss(), dense, ()
        elif case == "dense":
            fn, label, extra = L.SoftmaxCrossEntropyLoss(
                sparse_label=False), dense, ()
        else:
            fn, label, extra = L.SoftmaxCrossEntropyLoss(), sparse, ()
            if case == "weighted":
                extra = (pkg.nd.array(w),)
        p = pkg.nd.array(pred)
        p.attach_grad()
        with pkg.autograd.record():
            out = fn(p, pkg.nd.array(label), *extra)
            s = out.sum()
        s.backward()
        res[pkg] = (out, p.grad)
    assert res[tmx][0].shape == (4,)
    _close(res[tmx][0], res[mx][0], **_FWD)
    _close(res[tmx][1], res[mx][1], **_FWD)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_rule_matches_reference(momentum):
    """optimizer_rules' sgd over four steps: MXNet's order, g += wd * w;
    m = momentum * m - lr * g; w += m."""
    h = {"momentum": momentum}
    w0, gs = _rand(5, 3, seed=7), [_rand(5, 3, seed=8 + t) for t in range(4)]
    jw, tw = jnp.asarray(w0), torch.from_numpy(w0)
    js, ts = ref_rules._sgd_init(jw, h), port_rules._sgd_init(tw, h)
    assert len(ts) == len(js)
    for t, g in enumerate(gs, 1):
        jw, js = ref_rules._sgd_apply(jw, jnp.asarray(g), js, 0.05, 1e-4, t,
                                      h)
        tw, ts = port_rules._sgd_apply(tw, torch.from_numpy(g), ts, 0.05,
                                       1e-4, t, h)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **_EXACT)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **_EXACT)
    with pytest.raises(ValueError, match="no update rule"):
        port_rules.get("rmsprop")


def test_eager_sgd_update_matches_reference():
    res = {}
    for pkg in (mx, tmx):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   wd=1e-3, rescale_grad=0.5,
                                   clip_gradient=0.4)
        w = pkg.nd.array(_rand(4, 4, seed=9))
        state = opt.create_state(0, w)
        for t in range(3):
            opt.update(0, w, pkg.nd.array(_rand(4, 4, seed=10 + t)), state)
        res[pkg] = (w, state, opt.num_update)
    _close(res[tmx][0], res[mx][0], **_EXACT)
    _close(res[tmx][1], res[mx][1], **_EXACT)
    assert res[tmx][2] == res[mx][2] == 3


def test_trainstep_raises_for_what_a_later_slice_brings():
    with tmx.name.NameManager():
        net = _mlp(tmx)
    loss = tmx.gluon.loss.L2Loss()
    for kw, what in ((dict(mesh=object()), "mesh"),
                     (dict(remat="io"), "remat"),
                     (dict(guard=True), "guard"),
                     (dict(sharded_update=True), "sharded_update"),
                     (dict(quantized_collectives="int8"),
                      "quantized_collectives")):
        with pytest.raises(MXNetError, match=what):
            TrainStep(net, loss, "sgd", {"learning_rate": 0.1}, **kw)
    with pytest.raises(ValueError, match="rmsprop"):
        TrainStep(net, loss, "rmsprop")


def test_trainstep_bf16_keeps_float32_master_weights():
    """dtype="bfloat16": bf16 compute, float32 weights and loss, and the
    first step's loss near the float32 step's (bf16 rounding)."""
    with tmx.name.NameManager():
        net = _mlp(tmx)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((1, 7)))
    x, y = _rand(8, 7, seed=11), _rand(8, 5, seed=12)
    start = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    losses = {}
    for dtype in ("float32", "bfloat16"):
        gluon_params_from_numpy(net, start)
        step = TrainStep(net, tmx.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1}, dtype=dtype)
        losses[dtype] = [float(step(x, y)) for _ in range(3)]
        step.sync_params()
        for p in net.collect_params().values():
            assert p.data().dtype == np.float32
    assert losses["bfloat16"][0] == pytest.approx(losses["float32"][0],
                                                  rel=2e-2)
    assert losses["bfloat16"][-1] < losses["bfloat16"][0]


# ---------------------------------------------------------------------------
# contexts and initializers
# ---------------------------------------------------------------------------


def test_contexts():
    assert tmx.current_context() == tmx.cpu()      # the autouse fixture
    with tmx.Context("gpu", 1) as ctx:
        assert tmx.current_context() is ctx
    assert tmx.current_context() == tmx.cpu()
    assert tmx.num_gpus() == (torch.cuda.device_count()
                              if torch.cuda.is_available() else 0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            tmx.gpu(0)
        with pytest.raises(MXNetError):
            tmx.nd.zeros((2,), ctx=tmx.Context("gpu", 0))


def test_default_context_is_the_card():
    import threading
    seen = []
    t = threading.Thread(target=lambda: seen.append(tmx.current_context()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [tmx.Context("gpu", 0)]


def test_initializers():
    arr = tmx.nd.zeros((64, 32, 3, 3))
    tmx.init.Xavier(seed=3)(tmx.initializer.InitDesc("w_weight"), arr)
    bound = np.sqrt(3.0 / ((32 * 9 + 64 * 9) / 2.0))
    v = arr.asnumpy()
    assert np.abs(v).max() <= bound and np.abs(v).max() > 0.9 * bound
    again = tmx.nd.zeros((64, 32, 3, 3))
    tmx.init.Xavier(seed=3)(tmx.initializer.InitDesc("w_weight"), again)
    np.testing.assert_array_equal(again.asnumpy(), v)
    for name, want in (("b_bias", 0.0), ("bn_gamma", 1.0), ("bn_beta", 0.0),
                       ("bn_running_var", 1.0), ("bn_running_mean", 0.0)):
        a = tmx.nd.ones((4,)) * 7.0
        tmx.init.Xavier()(tmx.initializer.InitDesc(name), a)
        np.testing.assert_array_equal(a.asnumpy(), want)
    c = tmx.nd.zeros((2, 2))
    tmx.init.create("constant", value=0.5)(
        tmx.initializer.InitDesc("c_weight"), c)
    np.testing.assert_array_equal(c.asnumpy(), 0.5)
    with pytest.raises(ValueError, match="unknown initializer"):
        tmx.init.create("no_such_initializer")
