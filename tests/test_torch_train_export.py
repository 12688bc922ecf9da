"""`predict.export_train_step` and the C++ trainer (`mxtpu_train`)
on the CPU.

The artifact is held to the reference's contract (mxnet_tpu/predict.py
export_train_step: inputs [state..., x, y, seed, lr, t], outputs [loss,
state...], `train.txt`, `state/<i>.bin`, `meta.json`'s counts); its C++
steps to the port's TrainStep fed the same LCG batches (within 1e-5
relative), and its first step to the JAX reference's: the reference's
TrainStep cannot run here (its key API is missing from this jax), so its
oracle is `functionalize(net, train_mode=True)` with an explicit key
under jax.value_and_grad of the mean loss, and its `optimizer_rules` on
top (as tests/test_torch_trainstep_optimizers.py does). The reference's
own tests/test_train_export.py is not an oracle here. The artifacts are
made once per module.
"""
import json
import os
import re
import subprocess
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu import optimizer_rules as ref_rules
from mxnet_tpu.parallel.functional import functionalize

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpp_package
from mxnet_tpu_torch import optimizer_rules as port_rules
from mxnet_tpu_torch import predict as port_pred
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import gluon_params_from_numpy
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.parallel.mesh import Mesh

BATCH, DIN, HID, DOUT, STEPS = 8, 12, 16, 5, 5
OPT = {"learning_rate": 0.1, "momentum": 0.9}
_REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def tree():
    return cpp_package.build("cpu")


def _mlp(pkg, dropout=0.0):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(HID, in_units=DIN, activation="relu"))
    if dropout:
        net.add(pkg.gluon.nn.Dropout(dropout))
    net.add(pkg.gluon.nn.Dense(DOUT, in_units=HID))
    return net


def _batch(t):
    return cpp_package.lcg_batch(t, (BATCH, DIN), (BATCH,), "int32", DOUT)


def _train(tree, art, *args):
    p = subprocess.run([tree.mxtpu_train, art, "--device", "cpu", "--lr",
                        str(OPT["learning_rate"]), "--num-classes",
                        str(DOUT)] + list(args),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return [float(m.group(1))
            for m in re.finditer(r"step +\d+  loss (\S+)", p.stdout)], p


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The MLP in both packages on the reference's weights, its port
    TrainStep (SGD, momentum) exported before any step: (artifact, the
    step, the start weights by name, the names in the step's order)."""
    with tmx.cpu():
        with mx.name.NameManager():
            ref = _mlp(mx)
        ref.initialize(mx.init.Xavier())
        ref(mx.nd.zeros((1, DIN)))
        start = {n: p.data().asnumpy() for n, p in
                 ref.collect_params().items()}
        with tmx.name.NameManager():
            net = _mlp(tmx)
        net.initialize()
        net(tmx.nd.zeros((1, DIN)))
        gluon_params_from_numpy(net, start)
        step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", dict(OPT))
        art = str(tmp_path_factory.mktemp("mlp") / "mlp_train.mxtpu")
        port_pred.export_train_step(step, *_batch(1), art)
        return art, step, start, list(net.collect_params())


def test_artifact_layout(mlp):
    """The reference's contract (mxnet_tpu/predict.py:301-307): the
    signature's inputs [state..., x, y, seed, lr, t] and outputs [loss,
    state...], output 1+i shaped as input i; "n_state K"; each
    state/<i>.bin the raw bytes of the state's value; meta's counts; and
    the package for the step's device."""
    art, step, start, names = mlp
    with zipfile.ZipFile(art) as z:
        entries = z.namelist()
        sig = z.read("signature.txt").decode().splitlines()
        train = z.read("train.txt").decode()
        meta = json.loads(z.read("meta.json"))
        blobs = {n: z.read(n) for n in entries if n.startswith("state/")}
    n_g, n_o = len(names), len(names)  # every weight, one momentum each
    k = n_g + n_o
    assert train == "n_state %d\n" % k
    assert meta["train"] == {"n_state": k, "n_grad": n_g, "n_nograd": 0,
                             "n_opt": n_o}
    assert "aoti/cpu.pt2" in entries and "model.pt2" in entries
    ins = [ln.split(" ") for ln in sig if ln.startswith("in ")]
    outs = [ln.split(" ") for ln in sig if ln.startswith("out ")]
    assert len(ins) == k + 5 and len(outs) == k + 1
    assert ins[k] == ["in", "f32", "%dx%d" % (BATCH, DIN)]
    assert ins[k + 1] == ["in", "s32", "%d" % BATCH]
    assert [i[1:] for i in ins[k + 2:]] == [["s32", ""], ["f32", ""],
                                            ["s32", ""]]
    assert outs[0][1:] == ["f32", ""]
    for i in range(k):
        assert outs[1 + i][1:] == ins[i][1:]
    assert sorted(blobs) == sorted("state/%d.bin" % i for i in range(k))
    for i, n in enumerate(names):
        np.testing.assert_array_equal(
            np.frombuffer(blobs["state/%d.bin" % i], np.float32),
            start[n].ravel())
        assert not np.frombuffer(blobs["state/%d.bin" % (n_g + i)],
                                 np.float32).any()  # momentum starts at 0


def test_state_round_trips_through_mxtpu_train(tree, mlp):
    _, p = _train(tree, mlp[0], "--state-roundtrip-check")
    assert "state round-trip OK (%d tensors)" % (2 * len(mlp[3])) in p.stdout


@pytest.fixture(scope="module")
def cpp_run(tree, mlp, tmp_path_factory):
    """STEPS C++ steps from the exported state, the state written after
    the first step by a second run of one step."""
    d = tmp_path_factory.mktemp("state")
    losses, _ = _train(tree, mlp[0], "--steps", str(STEPS))
    first, _ = _train(tree, mlp[0], "--steps", "1", "--state-out", str(d))
    return losses, first, d


def test_cpp_steps_match_trainstep(mlp, cpp_run):
    """mxtpu_train's 5 losses against the port's TrainStep on the same
    LCG batches from the same state, within 1e-5 relative."""
    art, step, start, names = mlp
    losses = cpp_run[0]
    assert len(losses) == STEPS
    with tmx.cpu():
        with tmx.name.NameManager():
            net = _mlp(tmx)
        net.initialize()
        net(tmx.nd.zeros((1, DIN)))
        gluon_params_from_numpy(net, start)
        twin = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", dict(OPT))
        want = [float(twin(*(tmx.nd.array(a) for a in _batch(t))))
                for t in range(1, STEPS + 1)]
    for got, w in zip(losses, want):
        assert abs(got - w) <= _REL * abs(w), (losses, want)


def _reference_first_step(start, names, x, y):
    """The reference's step once: value_and_grad of its functionalized
    net's mean loss with an explicit key, then its SGD rule."""
    with mx.name.NameManager():
        ref = _mlp(mx)
    ref.initialize(mx.init.Xavier())
    ref(mx.nd.zeros((1, DIN)))
    for n, p in ref.collect_params().items():
        p.set_data(mx.nd.array(start[n]))
    apply_fn, ref_names, values = functionalize(ref, train_mode=True)
    assert list(ref_names) == names
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    opt = ref_opt.create("sgd", **dict(OPT))
    init, apply_rule = ref_rules.get(opt.rule_name)
    hyper = opt.rule_hyper()

    def loss(vals):
        out = apply_fn(vals, jnp.asarray(x), key=jax.random.PRNGKey(0))
        return jnp.mean(loss_fn(mx.nd.NDArray(out),
                                mx.nd.NDArray(jnp.asarray(y)))._data)

    value, grads = jax.value_and_grad(loss)(tuple(values))
    new = [np.asarray(apply_rule(v, g, init(v, hyper), opt.lr, opt.wd, 1,
                                 hyper)[0]) for v, g in zip(values, grads)]
    return float(value), dict(zip(names, new))


def test_first_step_matches_the_reference(mlp, cpp_run):
    """The C++ first step's loss and updated weights against the JAX
    reference's step on the same numpy weights and batch, within 1e-5 of
    the loss and of each weight's largest element."""
    art, step, start, names = mlp
    first, d = cpp_run[1], cpp_run[2]
    want_loss, want = _reference_first_step(start, names, *_batch(1))
    assert abs(first[0] - want_loss) <= _REL * abs(want_loss)
    for i, n in enumerate(names):
        got = np.fromfile(d / ("state%d.bin" % i), np.float32).reshape(
            want[n].shape)
        err = float(np.abs(got - want[n]).max()) / float(
            np.abs(want[n]).max())
        assert err <= _REL, (n, err)


def test_mesh_step_raises():
    with tmx.name.NameManager():
        net = _mlp(tmx)
    net.initialize()
    mesh = Mesh(np.arange(1), ("dp",), distributed=False)
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT), mesh=mesh)
    with pytest.raises(MXNetError, match="mesh-sharded"):
        port_pred.export_train_step(step, *_batch(1), "unused.mxtpu")


@pytest.mark.parametrize("flag,layer,kernel", [
    ("MXNET_FUSED_BN_EPILOGUE", "bn", "K3a"),
    ("MXNET_FUSED_RNN", "lstm", "K4b")])
def test_step_reaching_a_ctypes_kernel_raises(monkeypatch, tmp_path, flag,
                                              layer, kernel):
    """A step whose graph reaches a kernel launched through ctypes raises,
    naming it: the fused BatchNorm's K3a, the fused RNN's backward K4b
    (its forward, the op K4a, would trace); with the flag off the same
    step traces."""
    monkeypatch.setenv(flag, "1")
    with tmx.name.NameManager():
        net = tmx.gluon.nn.HybridSequential()
        if layer == "bn":
            net.add(tmx.gluon.nn.Dense(HID, in_units=DIN))
            net.add(tmx.gluon.nn.BatchNorm(in_channels=HID))
            x = _batch(1)[0]
        else:
            net.add(tmx.gluon.rnn.LSTM(HID, input_size=DIN))
            x = _batch(1)[0].reshape(2, BATCH // 2, DIN)
        net.add(tmx.gluon.nn.Dense(DOUT, flatten=False))
    net.initialize()
    net(tmx.nd.array(x))
    y = np.zeros(x.shape[:-1], np.int32)
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(OPT))
    with pytest.raises(MXNetError, match="reaches %s" % kernel):
        port_pred.export_train_step(step, x, y, str(tmp_path / "k.mxtpu"))


@pytest.fixture(scope="module")
def dropout_art(tmp_path_factory):
    with tmx.cpu():
        tmx.random.seed(3)
        with tmx.name.NameManager():
            net = _mlp(tmx, dropout=0.5)
        net.initialize(tmx.init.Xavier())
        net(tmx.nd.zeros((1, DIN)))
        step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", dict(OPT))
        art = str(tmp_path_factory.mktemp("drop") / "drop.mxtpu")
        port_pred.export_train_step(step, *_batch(1), art)
        return art


def test_dropout_step_follows_the_seed(tree, dropout_art):
    """The step's Dropout draws from the default generator that mxtpu_train
    seeds with `seed`: the same seeds give the same losses, other seeds
    other losses."""
    a, _ = _train(tree, dropout_art, "--steps", "3")
    b, _ = _train(tree, dropout_art, "--steps", "3")
    c, _ = _train(tree, dropout_art, "--steps", "3", "--seed-base", "100")
    assert a == b and len(a) == 3
    assert a != c and all(np.isfinite(c))


def test_rules_take_a_traced_lr_and_t():
    """A traced step passes lr and t as 0-d tensors: Adam's and SGLD's
    square roots take them (torch.sqrt) and give the float path's update
    within float32 rounding."""
    w = torch.linspace(-1, 1, 12)
    g = torch.linspace(0.5, -0.3, 12)
    h = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    init, apply = port_rules.get("adam")
    st = init(w, h)
    want = apply(w, g, st, 0.01, 0.0, 3, h)[0]
    got = apply(w, g, st, torch.tensor(0.01), 0.0, torch.tensor(3), h)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    sg = port_rules.get("sgld")[1](w, g, (), torch.tensor(0.04), 0.0, 1, {},
                                   key=gen)[0]
    gen.manual_seed(0)
    sf = port_rules.get("sgld")[1](w, g, (), 0.04, 0.0, 1, {}, key=gen)[0]
    torch.testing.assert_close(sg, sf, rtol=1e-6, atol=1e-7)
