"""The port's optimizers (mxnet_tpu_torch/optimizer.py, optimizer_rules.py)
against the JAX reference's on the CPU.

Each of the 16 registered optimizers runs 5 updates through the port's
Updater and the reference's from the same numpy weights and gradients;
the weights and every state buffer must agree within 1e-6 relative
(atol 1e-7): the rules are the same float32 ops in the same order. SGLD
draws its noise from another generator in each package, so it is held
by its moments instead: the mean of its update against the Langevin
drift and the variance against lr, over 40000 elements, within 4
standard errors. Then every case of tests/test_optimizer.py on the
port, with its tolerances, beside the reference where both run.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import optimizer as ref_opt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as port_opt
from mxnet_tpu_torch.ndarray import NDArray

_RTOL, _ATOL = 1e-6, 1e-7

#: the hyper-parameters of tests/test_trainstep_optimizers.py: each rule
#: takes a non-trivial path
OPT_PARAMS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
    "ccsgd": {"learning_rate": 0.1, "momentum": 0.9},
    "signum": {"learning_rate": 0.05, "momentum": 0.9, "wd_lh": 1e-3},
    "ftml": {"learning_rate": 0.02},
    "lbsgd": {"learning_rate": 0.1, "momentum": 0.9},
    "dcasgd": {"learning_rate": 0.05, "momentum": 0.9},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "sgld": {"learning_rate": 0.01},
    "adam": {"learning_rate": 0.01},
    "adagrad": {"learning_rate": 0.1},
    "rmsprop": {"learning_rate": 0.01, "centered": True},
    "adadelta": {},
    "ftrl": {"learning_rate": 0.1, "lamda1": 1e-4},
    "adamax": {"learning_rate": 0.01},
    "nadam": {"learning_rate": 0.01},
    "test": {},
}
#: further variants that take the rules' other branches
VARIANTS = [
    ("sgd", {"learning_rate": 0.1}),
    ("signum", {"learning_rate": 0.05, "momentum": 0.0, "wd": 1e-2}),
    ("dcasgd", {"learning_rate": 0.05, "wd": 1e-2}),
    ("nag", {"learning_rate": 0.1, "wd": 1e-2}),
    ("rmsprop", {"learning_rate": 0.01, "clip_weights": 0.5}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.3, "wd": 1e-2}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-2, "clip_gradient": 0.3,
              "rescale_grad": 2.0}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
               "warmup_epochs": 1, "updates_per_epoch": 2}),
    ("nadam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.5, "wd": 1e-2}),
]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _flat_states(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        out = []
        for s in state:
            out.extend(_flat_states(s))
        return out
    return [state]


def _run(pkg, name, params, steps=5, shape=(4, 5), seed=0):
    rng = np.random.RandomState(seed)
    w0 = rng.uniform(-1, 1, shape).astype(np.float32)
    grads = [rng.uniform(-1, 1, shape).astype(np.float32)
             for _ in range(steps)]
    o = pkg.optimizer.create(name, **dict(params))
    upd = pkg.optimizer.get_updater(o)
    ws = [pkg.nd.array(w0), pkg.nd.array(w0[::-1].copy())]
    for g in grads:
        for i, w in enumerate(ws):
            upd(i, pkg.nd.array(g if i == 0 else -g), w)
    return ([w.asnumpy() for w in ws],
            [[s.asnumpy() for s in _flat_states(upd.states[i])]
             for i in range(len(ws))])


@pytest.mark.parametrize("name", sorted(set(OPT_PARAMS) - {"sgld"}))
def test_updater_matches_reference(name):
    ref_w, ref_s = _run(mx, name, OPT_PARAMS[name])
    got_w, got_s = _run(tmx, name, OPT_PARAMS[name])
    for a, b in zip(got_w, ref_w):
        np.testing.assert_allclose(a, b, rtol=_RTOL, atol=_ATOL)
    assert [len(s) for s in got_s] == [len(s) for s in ref_s]
    for sa, sb in zip(got_s, ref_s):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a, b, rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("name,params", VARIANTS,
                         ids=["%s-%d" % (n, i) for i, (n, _)
                              in enumerate(VARIANTS)])
def test_updater_variants_match_reference(name, params):
    ref_w, ref_s = _run(mx, name, params, seed=3)
    got_w, got_s = _run(tmx, name, params, seed=3)
    for a, b in zip(got_w + sum(got_s, []), ref_w + sum(ref_s, [])):
        np.testing.assert_allclose(a, b, rtol=_RTOL, atol=_ATOL)


def test_sgld_noise_moments():
    """w' = w - lr/2 (g + wd w) + N(0, lr): the update's mean and
    variance over 40000 elements."""
    lr, wd = 0.01, 0.1
    o = port_opt.create("sgld", learning_rate=lr, wd=wd)
    upd = port_opt.get_updater(o)
    tmx.random.seed(5)
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, (200, 200)).astype(np.float32)
    g = rng.uniform(-1, 1, (200, 200)).astype(np.float32)
    w = tmx.nd.array(w0)
    upd(0, tmx.nd.array(g), w)
    noise = w.asnumpy() - (w0 - lr / 2 * (g + wd * w0))
    n = noise.size
    assert abs(noise.mean()) < 4 * np.sqrt(lr / n)
    assert abs(noise.var() - lr) < 4 * lr * np.sqrt(2.0 / n)


def test_sgld_draws_from_the_device_generator_in_order():
    """Seeded alike, two SGLD runs draw the same noise, and it is the
    device generator's draw for each parameter in turn."""
    outs = []
    for _ in range(2):
        tmx.random.seed(9)
        o = port_opt.create("sgld", learning_rate=0.04)
        upd = port_opt.get_updater(o)
        ws = [tmx.nd.zeros((3, 4)), tmx.nd.zeros((5,))]
        for i, w in enumerate(ws):
            upd(i, tmx.nd.zeros(w.shape), w)
        outs.append([w.asnumpy() for w in ws])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    tmx.random.seed(9)
    gen = tmx.random.generator("cpu")
    want = [torch.randn((3, 4), generator=gen) * 0.2,
            torch.randn((5,), generator=gen) * 0.2]
    for a, b in zip(outs[0], want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)


def test_registry_has_the_reference_keys():
    assert sorted(port_opt.Optimizer.opt_registry) == \
        sorted(ref_opt.Optimizer.opt_registry)
    for name in port_opt.Optimizer.opt_registry:
        assert port_opt.create(name).rule_name is not None


# ---------------------------------------------------------------------------
# tests/test_optimizer.py, case by case
# ---------------------------------------------------------------------------

ALL_OPTS = ["sgd", "nag", "adam", "adagrad", "rmsprop", "adadelta", "ftrl",
            "adamax", "nadam", "signum", "ftml", "dcasgd", "sgld", "lbsgd"]


def _quadratic_steps(pkg, name, nsteps):
    o = pkg.optimizer.create_optimizer(name, learning_rate=0.1)
    updater = pkg.optimizer.get_updater(o)
    w = pkg.nd.array(np.array([1.0, -2.0, 3.0], np.float32))
    for _ in range(nsteps):
        updater(0, w * 0.2 + 0.1, w)
    return w.asnumpy()


@pytest.mark.parametrize("name", ALL_OPTS)
def test_optimizer_decreases_quadratic(name):
    """Progress on f(w) = 0.1 w^2 + 0.1 w, and the reference's own end
    point (SGLD: it runs)."""
    if name == "sgld":
        _quadratic_steps(tmx, name, 5)
        return
    w_end = _quadratic_steps(tmx, name, 20)
    w0 = np.array([1.0, -2.0, 3.0])
    assert (0.1 * w_end ** 2 + 0.1 * w_end).sum() < \
        (0.1 * w0 ** 2 + 0.1 * w0).sum()
    np.testing.assert_allclose(w_end, _quadratic_steps(mx, name, 20),
                               rtol=1e-5, atol=1e-6)


def test_sgd_matches_numpy():
    o = port_opt.SGD(learning_rate=0.1, momentum=0.9, wd=0.01,
                     rescale_grad=1.0)
    updater = port_opt.get_updater(o)
    w = tmx.nd.array(np.array([1.0, 2.0], np.float32))
    wn = np.array([1.0, 2.0], np.float32)
    mom = np.zeros_like(wn)
    for _ in range(5):
        g = np.array([0.3, -0.4], np.float32)
        updater(0, tmx.nd.array(g), w)
        mom = 0.9 * mom - 0.1 * (g + 0.01 * wn)
        wn = wn + mom
        np.testing.assert_allclose(w.asnumpy(), wn, rtol=1e-4, atol=1e-5)


def test_adam_matches_numpy():
    updater = port_opt.get_updater(port_opt.Adam(learning_rate=0.01))
    w = tmx.nd.array(np.array([1.0, 2.0], np.float32))
    wn, m, v = np.array([1.0, 2.0]), np.zeros(2), np.zeros(2)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, 6):
        g = np.array([0.3, -0.4])
        updater(0, tmx.nd.array(g.astype(np.float32)), w)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        wn = wn - 0.01 * np.sqrt(1 - b2 ** t) / (1 - b1 ** t) * m / (
            np.sqrt(v) + eps)
        np.testing.assert_allclose(w.asnumpy(), wn.astype(np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_adagrad_matches_numpy():
    updater = port_opt.get_updater(port_opt.AdaGrad(learning_rate=0.5,
                                                    eps=1e-7))
    w = tmx.nd.array(np.array([1.0], np.float32))
    wn, h = np.array([1.0]), np.zeros(1)
    for _ in range(4):
        g = np.array([0.5])
        updater(0, tmx.nd.array(g.astype(np.float32)), w)
        h += g * g
        wn = wn - 0.5 * g / np.sqrt(h + 1e-7)
        np.testing.assert_allclose(w.asnumpy(), wn.astype(np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_lr_scheduler_in_optimizer():
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    updater = port_opt.get_updater(port_opt.SGD(learning_rate=1.0,
                                                lr_scheduler=sched))
    w = tmx.nd.array(np.array([0.0], np.float32))
    deltas, prev = [], 0.0
    for _ in range(6):
        updater(0, tmx.nd.array(np.array([1.0], np.float32)), w)
        cur = float(w.asnumpy()[0])
        deltas.append(prev - cur)
        prev = cur
    assert abs(deltas[0] - 1.0) < 1e-5
    assert abs(deltas[3] - 0.5) < 1e-5
    assert abs(deltas[5] - 0.25) < 1e-5


def test_wd_and_rescale():
    updater = port_opt.get_updater(port_opt.SGD(learning_rate=0.1, wd=0.1,
                                                rescale_grad=0.5))
    w = tmx.nd.array(np.array([2.0], np.float32))
    updater(0, tmx.nd.array(np.array([4.0], np.float32)), w)
    np.testing.assert_allclose(w.asnumpy(), [1.78], rtol=1e-5)


def test_clip_gradient():
    updater = port_opt.get_updater(port_opt.SGD(learning_rate=1.0,
                                                clip_gradient=0.5))
    w = tmx.nd.array(np.array([0.0], np.float32))
    updater(0, tmx.nd.array(np.array([10.0], np.float32)), w)
    np.testing.assert_allclose(w.asnumpy(), [-0.5], rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_multi_precision_sgd(dtype):
    """A float32 master under the half-precision weight (the reference's
    covers float16; the port's bfloat16 too)."""
    o = port_opt.SGD(learning_rate=0.1, momentum=0.9, multi_precision=True)
    updater = port_opt.get_updater(o)
    w = tmx.nd.array(np.array([1.0, 2.0], np.float32)).astype(dtype)
    g = tmx.nd.array(np.array([0.1, 0.1], np.float32)).astype(dtype)
    updater(0, g, w)
    assert w.dtype == dtype
    master, mom = updater.states[0]
    assert master.dtype == np.float32
    g32 = g.astype("float32").asnumpy()
    np.testing.assert_allclose(master.asnumpy(),
                               np.array([1.0, 2.0], np.float32) - 0.1 * g32,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "dcasgd", "nadam", "rmsprop"])
def test_updater_states_roundtrip(name):
    """get_states(dump_optimizer=True) into a fresh Updater continues the
    same trajectory (DCASGD's (None, previous weight) and Nadam's three
    parts included); the bytes the reference writes for the same states
    hold the same arrays."""
    params = {"learning_rate": 0.01}
    if name == "rmsprop":
        params["centered"] = True
    updater = port_opt.get_updater(port_opt.create(name, **params))
    w = tmx.nd.array(np.array([1.0, 2.0], np.float32))
    g = tmx.nd.array(np.array([0.3, -0.4], np.float32))
    updater(0, g, w)
    blob = updater.get_states(dump_optimizer=True)
    updater2 = port_opt.get_updater(port_opt.create(name, **params))
    updater2.set_states(blob)
    w2 = tmx.nd.array(w.asnumpy())
    updater(0, g, w)
    updater2(0, g, w2)
    np.testing.assert_allclose(w.asnumpy(), w2.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    ref_upd = ref_opt.get_updater(ref_opt.create(name, **params))
    ref_upd(0, mx.nd.array(np.array([0.3, -0.4], np.float32)),
            mx.nd.array(np.array([1.0, 2.0], np.float32)))
    ref_host = pickle.loads(ref_upd.get_states())
    one = port_opt.get_updater(port_opt.create(name, **params))
    one(0, tmx.nd.array(np.array([0.3, -0.4], np.float32)),
        tmx.nd.array(np.array([1.0, 2.0], np.float32)))
    got_host = pickle.loads(one.get_states())
    assert type(got_host[0]) is type(ref_host[0])
    for a, b in zip(_flat_host(got_host[0]), _flat_host(ref_host[0])):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def _flat_host(v):
    if isinstance(v, (tuple, list)):
        return sum((_flat_host(x) for x in v), [])
    return [] if v is None else [np.asarray(v)]


def test_per_param_lr_mult():
    o = port_opt.SGD(learning_rate=1.0)
    o.set_lr_mult({"slow": 0.1})
    o.set_wd_mult({})
    o.idx2name = {0: "slow", 1: "fast"}
    updater = port_opt.get_updater(o)
    ws = tmx.nd.array(np.array([0.0], np.float32))
    wf = tmx.nd.array(np.array([0.0], np.float32))
    g = tmx.nd.array(np.array([1.0], np.float32))
    updater(0, g, ws)
    updater(1, g, wf)
    np.testing.assert_allclose(ws.asnumpy(), [-0.1], rtol=1e-5)
    np.testing.assert_allclose(wf.asnumpy(), [-1.0], rtol=1e-5)


def test_create_optimizer_registry():
    for name in ALL_OPTS:
        assert isinstance(port_opt.create_optimizer(name, learning_rate=0.1),
                          port_opt.Optimizer)


def test_sgd_momentum_and_adam_trajectories_match_torch():
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 4).astype(np.float32)
    grads = [rng.randn(6, 4).astype(np.float32) for _ in range(10)]
    for name, kwargs, topt, tkw in [
            ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.0},
             torch.optim.SGD, {"lr": 0.1, "momentum": 0.9}),
            ("adam", {"learning_rate": 0.01, "beta1": 0.9, "beta2": 0.999,
                      "epsilon": 1e-8, "wd": 0.0},
             torch.optim.Adam, {"lr": 0.01, "betas": (0.9, 0.999),
                                "eps": 1e-8})]:
        upd = port_opt.get_updater(port_opt.create(name, rescale_grad=1.0,
                                                   **kwargs))
        w = tmx.nd.array(w0.copy())
        wt = torch.tensor(w0.copy(), requires_grad=True)
        topti = topt([wt], **tkw)
        for g in grads:
            upd(0, tmx.nd.array(g), w)
            wt.grad = torch.tensor(g)
            topti.step()
        np.testing.assert_allclose(w.asnumpy(), wt.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_set_lr_scale_is_deprecated_as_in_the_reference():
    for pkg in (ref_opt, port_opt):
        with pytest.raises(DeprecationWarning, match="set_lr_mult"):
            pkg.SGD().set_lr_scale({"w": 0.5})


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop"])
def test_row_sparse_gradient_raises_naming_slice_6(name):
    """A row_sparse gradient through the Updater matches the reference's
    update: SGD and Adam lazily over the stored rows (the others keep
    their values bit for bit), RMSProp through its densified gradient.
    (The name is kept from before sparse arrays, when it raised.)"""
    from mxnet_tpu.ndarray import sparse as ref_sp
    from mxnet_tpu_torch.ndarray import sparse as port_sp
    rng = np.random.RandomState(3)
    w0 = rng.randn(5, 2).astype(np.float32)
    vals = rng.randn(2, 2).astype(np.float32)
    rows = np.array([1, 3], np.int32)
    got = []
    for pkg, opt, sp in ((tmx, port_opt, port_sp), (mx, ref_opt, ref_sp)):
        updater = opt.get_updater(opt.create(name, wd=0.01))
        w = pkg.nd.array(w0)
        for _ in range(2):
            updater(0, sp.RowSparseNDArray(rows, vals, (5, 2)), w)
        got.append(w.asnumpy())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)
    if name != "rmsprop":
        np.testing.assert_array_equal(got[0][[0, 2, 4]], w0[[0, 2, 4]])


@pytest.mark.parametrize("name", sorted(OPT_PARAMS))
def test_each_optimizer_through_the_callers(name, tmp_path):
    """gluon.Trainer, Module.init_optimizer, kvstore.set_optimizer and
    BucketingModule take every optimizer by name and by instance."""
    from mxnet_tpu_torch import gluon
    params = dict(OPT_PARAMS[name])
    with tmx.name.NameManager():
        net = gluon.nn.Dense(3, in_units=4)
    net.initialize(tmx.init.Xavier())
    for opt_arg, opt_params in ((name, params),
                                (port_opt.create(name, **params), None)):
        trainer = gluon.Trainer(net.collect_params(), opt_arg, opt_params)
        with tmx.autograd.record():
            loss = (net(tmx.nd.ones((2, 4))) ** 2).sum()
        loss.backward()
        trainer.step(2)
        assert np.all(np.isfinite(net.weight.data().asnumpy()))
    kv = tmx.kv.create("local")
    kv.set_optimizer(port_opt.create(name, **params))
    kv.init(0, tmx.nd.ones((2, 2)))
    kv.push(0, tmx.nd.ones((2, 2)) * 0.1)
    out = tmx.nd.zeros((2, 2))
    kv.pull(0, out=out)
    assert np.all(np.isfinite(out.asnumpy()))
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
    sym = tmx.sym.SoftmaxOutput(fc, name="softmax")
    it = tmx.io.NDArrayIter(np.random.RandomState(0).rand(8, 4)
                            .astype(np.float32),
                            np.arange(8, dtype=np.float32) % 3,
                            batch_size=4)
    for opt_arg, opt_params in ((name, params),
                                (port_opt.create(name, **params), ())):
        mod = tmx.mod.Module(sym, context=tmx.cpu())
        mod.fit(it, num_epoch=1, optimizer=opt_arg,
                optimizer_params=opt_params if opt_params is not None
                else (), initializer=tmx.init.Xavier())
        it.reset()
        assert np.all(np.isfinite(mod.get_params()[0]["fc_weight"]
                                  .asnumpy()))
    bmod = tmx.mod.BucketingModule(lambda key: (sym, ("data",),
                                                ("softmax_label",)),
                                   default_bucket_key=4,
                                   context=tmx.cpu())
    bmod.bind(it.provide_data, it.provide_label)
    bmod.init_params(tmx.init.Xavier())
    bmod.init_optimizer(optimizer=port_opt.create(name, **params))
    batch = next(iter(it))
    bmod.forward(batch)
    bmod.backward()
    bmod.update()
    assert np.all(np.isfinite(bmod.get_params()[0]["fc_weight"].asnumpy()))
