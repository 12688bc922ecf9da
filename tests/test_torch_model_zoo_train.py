"""Port parity for the model zoo's new families in training (mxnet_tpu_
torch/gluon/model_zoo/vision/) against the JAX reference on the CPU.

- One training step with MXNET_FUSED_BN_EPILOGUE=1 (the reference's K3
  in interpret mode, under jit(value_and_grad) of its functionalized net;
  the port's plain versions of K3a-d, eagerly under record, through the
  BatchNorm of depthwise layers and of concat-grown channels) on a small
  DenseNet(16, 8, (2, 2)) at 64x64, batch 4 (two dense blocks, so the
  7x7 head pool covers one window of an 8x8 map) and
  mobilenetv2_0.25 at 32x32, batch 16: the loss within 1e-5, and each
  gradient within test_torch_hybridize.py's tolerance, 1e-5 of the
  net's largest gradient element, or, where wider, twice the most any
  of the reference's own gradient elements moves when its input moves
  by one ulp up or down (`_ulp_floor`). mobilenetv2_0.25's 1x1 stages
  normalize 16 values a channel and its ReLU6 clips at two kinks: that
  movement is 1.5e-3 at batch 16 (3.8e-5 of the largest element, whose
  own flag-on and flag-off gradients differ by 2.5e-3; the port's by
  1.5e-3) and 2.2e-2 of the largest element at batch 4, so batch 16.
- Each new family hybridized against its eager self: training-mode
  outputs, gradients and moving statistics, then inference outputs
  (dropout off), and Inception's `_Concurrent` traced into Concat nodes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.parallel.functional import functionalize

import mxnet_tpu_torch as tmx

from test_torch_model_zoo import _twin

_REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _small_densenet(pkg):
    return pkg.gluon.model_zoo.vision.DenseNet(16, 8, (2, 2), classes=10)


def _mobilenet_v2(pkg):
    return pkg.gluon.model_zoo.vision.get_model("mobilenetv2_0.25",
                                                classes=10)


#: (make, image size, batch)
STEP_NETS = {"densenet_small": (_small_densenet, 64, 4),
             "mobilenetv2_0.25": (_mobilenet_v2, 32, 16)}


def _batch(size, n=4, classes=10, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 3, size, size)).astype(np.float32)
    y = rng.randint(0, classes, (n,)).astype(np.float32)
    return x, y


def _reference_step(ref, y):
    """jit(value_and_grad) of the reference's mean loss as a function of
    the input batch (its parameters fixed), and the parameter names."""
    apply_fn, names, values = functionalize(ref, train_mode=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(vals, x):
        out = apply_fn(vals, x, key=jax.random.PRNGKey(0))
        return jnp.mean(loss_fn(mx.nd.NDArray(out),
                                mx.nd.NDArray(jnp.asarray(y)))._data)

    step = jax.jit(jax.value_and_grad(loss))
    return (lambda x: step(values, jnp.asarray(x))), names


def _ulp_floor(step, x, want_grads):
    """The largest change of any of the reference's gradient elements
    when every input element moves by one ulp, up or down: how far the
    net's own float32 rounding determines its gradients."""
    worst = 0.0
    for to in (np.inf, -np.inf):
        _, moved = step(np.nextafter(x, np.float32(to)))
        worst = max(worst, max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(moved, want_grads.values())))
    return worst


@pytest.mark.parametrize("net", sorted(STEP_NETS))
def test_flag_on_training_step_matches_reference(net, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", "1")
    make, size, batch = STEP_NETS[net]
    ref, port, _ = _twin(make, size, seed=3)
    x, y = _batch(size, n=batch)
    step, names = _reference_step(ref, y)
    want_loss, want_grads = step(x)
    want_grads = dict(zip(names, want_grads))
    floor = _ulp_floor(step, x, want_grads)
    port_loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        out = port(tmx.nd.array(x))
        total = port_loss(out, tmx.nd.array(y)).mean()
    total.backward()
    assert float(total.asnumpy()) == pytest.approx(float(want_loss),
                                                   rel=_REL)
    params = port.collect_params()
    grads = {n: np.asarray(g) for n, g in want_grads.items()
             if params[n].grad_req != "null"}
    top = max(float(np.abs(g).max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(params[n].grad().asnumpy(), g, rtol=0,
                                   atol=max(_REL * top, 2 * floor),
                                   err_msg=n)


HYBRID = {"alexnet": ("alexnet", 64), "vgg11_bn": ("vgg11_bn", 32),
          "squeezenet1.1": ("squeezenet1.1", 48),
          "densenet_small": (None, 64), "mobilenet0.25": ("mobilenet0.25", 32),
          "mobilenetv2_0.25": ("mobilenetv2_0.25", 32),
          "inceptionv3": ("inceptionv3", 75)}


def _train_forward(net, x, y):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        out = net(tmx.nd.array(x))
        loss = loss_fn(out, tmx.nd.array(y)).mean()
    loss.backward()
    params = net.collect_params()
    return (out.asnumpy(),
            {n: p.grad().asnumpy().copy() for n, p in params.items()
             if p.grad_req != "null"},
            {n: p.data().asnumpy().copy() for n, p in params.items()})


@pytest.mark.parametrize("family", sorted(HYBRID))
def test_hybridized_equals_eager(family):
    """Training-mode outputs, gradients and moving statistics, then
    inference outputs, of the cached graph against the eager blocks
    (dropout off: the two modes draw their masks in another order)."""
    name, size = HYBRID[family]
    with tmx.name.NameManager():
        net = _small_densenet(tmx) if name is None else \
            tmx.gluon.model_zoo.vision.get_model(name, classes=10)
    for block in _blocks(net):
        if isinstance(block, tmx.gluon.nn.Dropout):
            block._rate = 0.0
    net.initialize(tmx.init.Xavier())
    x, y = _batch(size, n=2, seed=5)
    net(tmx.nd.array(x))
    start = {n: p.data().asnumpy().copy()
             for n, p in net.collect_params().items()}
    eager = _train_forward(net, x, y)
    infer_eager = net(tmx.nd.array(x)).asnumpy()
    for n, p in net.collect_params().items():
        p.set_data(tmx.nd.array(start[n]))
    net.hybridize()
    hybrid = _train_forward(net, x, y)
    assert net._cached_graph is not None
    infer_hybrid = net(tmx.nd.array(x)).asnumpy()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hybrid[0], eager[0], **tol)
    np.testing.assert_allclose(infer_hybrid, infer_eager, **tol)
    for n in eager[1]:
        np.testing.assert_allclose(hybrid[1][n], eager[1][n], err_msg=n,
                                   **tol)
    for n in eager[2]:
        np.testing.assert_allclose(hybrid[2][n], eager[2][n], err_msg=n,
                                   **tol)


def _blocks(block):
    yield block
    for child in block._children.values():
        yield from _blocks(child)


def test_inception_concurrent_traces_concat_nodes():
    """Inception's `_Concurrent` (hybrid_forward) becomes Concat nodes of
    the cached graph: one per A/B/C/D/E block and two more per E block's
    split branches (15 in all)."""
    with tmx.name.NameManager():
        net = tmx.gluon.model_zoo.vision.inception_v3(classes=10)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_batch(75, n=1)[0])
    net(x)
    net.hybridize()
    net(x)
    graph = net._cached_graph[1][0]
    ops = [n.op.name for n in graph._topo() if n.op is not None]
    assert ops.count("Concat") == 15
    assert ops.count("BatchNorm") == 94
