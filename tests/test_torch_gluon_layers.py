"""Port parity for the rest of Gluon's layers and the ops under them
(mxnet_tpu_torch/gluon/nn/, ops/nn.py, ops/tensor.py) against the JAX
reference on the CPU.

The ops: LeakyReLU in each act_type (rrelu, which draws its slopes in
training, by the moments of those slopes; at inference exactly),
Deconvolution in 1-3 dimensions with stride, padding, output padding
(adj), dilation and groups, LayerNorm, InstanceNorm, Pad in its three
modes, stack and SequenceMask along either axis; each forward and its
input gradients against the reference's, and the Symbol side's shape
rules (meta-device inference) for the parameter ops. The layers: each of
LayerNorm, InstanceNorm, Lambda, HybridLambda, LeakyReLU, PReLU, ELU,
SELU, Swish, GELU, Conv1D/3D, Conv1D/2D/3DTranspose, the 1-3-D max and
average pools (padding, ceil mode, count_include_pad) and their global
forms, and ReflectionPad2D, built in both packages under fresh
NameManagers (so the names agree), the reference's weights carried over
by name; the output, the input's gradient and each parameter's gradient
of sum(out * head) for a seeded head. Each layer also hybridized against
its eager self.

Tolerances, float32: elementwise ops, padding, stacking, masking and
pooling within 1e-6 (the same operations); convolutions and the
normalizations within 1e-5, their gradients within 1e-4 (sums in
another order).
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import gluon_params_from_numpy

_EXACT = dict(rtol=1e-6, atol=1e-6)
_FWD = dict(rtol=1e-5, atol=1e-5)
_GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _key_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _op_grads(pkg, op, arrays, kwargs, head, train):
    """(output, [input gradients]) of pkg.nd.<op>(*arrays, **kwargs) and
    the backward of sum(out * head), recorded in training mode or not."""
    ins = [pkg.nd.array(a) for a in arrays]
    for a in ins:
        a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = getattr(pkg.nd, op)(*ins, **kwargs)
        loss = (out * pkg.nd.array(head)).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in ins]


def _check_op(op, arrays, kwargs, tol, seed=9, train=True):
    with mx.name.NameManager(), _key_scope():
        shape = getattr(mx.nd, op)(*[mx.nd.array(a) for a in arrays],
                                   **kwargs).shape
    head = _rand(*shape, seed=seed)
    with _key_scope():
        want, want_g = _op_grads(mx, op, arrays, kwargs, head, train)
    got, got_g = _op_grads(tmx, op, arrays, kwargs, head, train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "prelu",
                                 "prelu_scalar", "rrelu_eval"])
def test_leaky_relu_matches_reference(act):
    x = _rand(3, 4, 5, 2, seed=1)
    if act == "prelu":
        _check_op("LeakyReLU", [x, np.linspace(0.1, 0.4, 4).astype(
            np.float32)], dict(act_type="prelu"), _EXACT)
    elif act == "prelu_scalar":
        _check_op("LeakyReLU", [x, np.array([0.3], np.float32)],
                  dict(act_type="prelu"), _EXACT)
    elif act == "rrelu_eval":
        _check_op("LeakyReLU", [x], dict(act_type="rrelu",
                                         lower_bound=0.1, upper_bound=0.5),
                  _EXACT, train=False)
    else:
        _check_op("LeakyReLU", [x], dict(act_type=act, slope=0.2), _EXACT)


def test_rrelu_training_slopes_by_their_moments():
    """In training each negative element is scaled by its own slope, drawn
    uniformly from [lower_bound, upper_bound) by the device's generator:
    the slopes' mean, variance and range are the uniform law's, positive
    elements pass, a reseed repeats the draw and another seed does not."""
    lo, hi = 0.125, 0.334
    x = -np.ones((200, 500), np.float32)
    x[:, :10] = 2.0

    def draw(seed):
        tmx.random.seed(seed)
        with tmx.autograd.train_mode():
            return tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="rrelu",
                                    lower_bound=lo,
                                    upper_bound=hi).asnumpy()

    out = draw(3)
    np.testing.assert_array_equal(out[:, :10], 2.0)
    slopes = -out[:, 10:]
    n = slopes.size
    mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
    assert abs(slopes.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(slopes.var() - var) < 5 * var * np.sqrt(0.8 / n)
    assert slopes.min() >= lo and slopes.max() < hi
    np.testing.assert_array_equal(draw(3), out)
    assert not np.array_equal(draw(4), out)


_DECONV = {
    "1d": ((2, 4, 7), (4, 3, 3), dict(kernel=(3,), num_filter=3)),
    "2d_stride_pad": ((2, 4, 5, 6), (4, 3, 3, 3),
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           num_filter=3)),
    "2d_adj_dilate": ((1, 4, 5, 5), (4, 2, 3, 2),
                      dict(kernel=(3, 2), stride=(2, 3), adj=(1, 2),
                           dilate=(1, 2), num_filter=2)),
    "2d_groups_bias": ((2, 4, 4, 4), (4, 3, 2, 2),
                       dict(kernel=(2, 2), stride=(2, 2), num_group=2,
                            num_filter=6, no_bias=False)),
    "3d": ((1, 2, 3, 4, 3), (2, 3, 2, 2, 2),
           dict(kernel=(2, 2, 2), stride=(1, 2, 1), num_filter=3)),
}


@pytest.mark.parametrize("case", sorted(_DECONV))
def test_deconvolution_matches_reference(case):
    dshape, wshape, kw = _DECONV[case]
    arrays = [_rand(*dshape, seed=1), _rand(*wshape, seed=2)]
    if not kw.get("no_bias", True):
        arrays.append(_rand(kw["num_filter"], seed=3))
    _check_op("Deconvolution", arrays, kw, _FWD)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_op_matches_reference(axis):
    x = _rand(3, 4, 5, seed=1) * 3 + 1
    c = x.shape[axis]
    _check_op("LayerNorm", [x, _rand(c, seed=2), _rand(c, seed=3)],
              dict(axis=axis, eps=1e-5), _FWD)


@pytest.mark.parametrize("shape", [(2, 3, 7), (2, 3, 4, 5)])
def test_instance_norm_op_matches_reference(shape):
    x = _rand(*shape, seed=1) * 2 - 1
    _check_op("InstanceNorm", [x, _rand(3, seed=2), _rand(3, seed=3)],
              dict(eps=1e-3), _FWD)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_matches_reference(mode):
    x = _rand(2, 3, 5, 4, seed=1)
    kw = dict(mode=mode, pad_width=(0, 0, 0, 0, 2, 1, 3, 2))
    if mode == "constant":
        kw["constant_value"] = 0.5
    _check_op("Pad", [x], kw, _EXACT)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stack_matches_reference(axis):
    _check_op("stack", [_rand(3, 4, seed=i) for i in range(3)],
              dict(axis=axis), _EXACT)


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_mask_matches_reference(axis):
    x = _rand(5, 3, 2, seed=1) if axis == 0 else _rand(3, 5, 2, seed=1)
    lengths = np.array([2, 5, 0], np.float32)
    ref = mx.nd.SequenceMask(mx.nd.array(x), mx.nd.array(lengths),
                             use_sequence_length=True, value=-1.0,
                             axis=axis).asnumpy()
    xp = tmx.nd.array(x)
    xp.attach_grad()
    with tmx.autograd.record():
        got = tmx.nd.SequenceMask(xp, tmx.nd.array(lengths),
                                  use_sequence_length=True, value=-1.0,
                                  axis=axis)
    got.backward()
    np.testing.assert_array_equal(got.asnumpy(), ref)
    np.testing.assert_array_equal(xp.grad.asnumpy(), (ref != -1.0) |
                                  (x == -1.0))
    np.testing.assert_array_equal(
        tmx.nd.SequenceMask(tmx.nd.array(x)).asnumpy(), x)


def _shape_case(pkg, op):
    """(symbol, the input shapes) of one op over Variables."""
    S, v = pkg.sym, pkg.sym.Variable
    data = {"data": (2, 4, 5, 6)}
    if op == "Deconvolution":
        return S.Deconvolution(v("data"), kernel=(3, 2), stride=(2, 2),
                               num_filter=6, num_group=2, no_bias=False), data
    if op == "LayerNorm":
        return S.LayerNorm(v("data"), axis=1), data
    if op == "InstanceNorm":
        return S.InstanceNorm(v("data")), data
    if op == "LeakyReLU":
        return S.LeakyReLU(v("data"), act_type="prelu"), data
    if op == "Pad":
        return S.Pad(v("data"), mode="reflect",
                     pad_width=(0, 0, 0, 0, 1, 2, 2, 1)), data
    if op == "stack":
        return S.stack(v("a"), v("b"), axis=1), {"a": (3, 4), "b": (3, 4)}
    return (S.SequenceMask(v("data"), v("len"), use_sequence_length=True),
            {"data": (5, 3, 2), "len": (3,)})


@pytest.mark.parametrize("op", ["Deconvolution", "LayerNorm", "InstanceNorm",
                                "LeakyReLU", "Pad", "stack",
                                "SequenceMask"])
def test_symbol_shape_rules_match_reference(op):
    """The parameters' shapes inferred from the data's, and the output's
    (the port runs each op on the meta device)."""
    shapes = {}
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            s, given = _shape_case(pkg, op)
        shapes[pkg] = (s.list_arguments(), s.infer_shape(**given))
    assert shapes[tmx][0] == shapes[mx][0]
    assert [list(map(tuple, x)) for x in shapes[tmx][1]] == \
        [list(map(tuple, x)) for x in shapes[mx][1]]
    with tmx.name.NameManager():
        leaky = tmx.sym.LeakyReLU(tmx.sym.Variable("data"), act_type="elu")
    assert leaky.list_arguments() == ["data"]


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _layer(name):
    """(make(pkg) -> block, input shape)."""
    return {
        "layernorm": (lambda p: p.gluon.nn.LayerNorm(), (3, 4, 6)),
        "layernorm_axis1": (lambda p: p.gluon.nn.LayerNorm(
            axis=1, center=False, epsilon=1e-3), (3, 4, 6)),
        "instancenorm": (lambda p: p.gluon.nn.InstanceNorm(), (2, 3, 4, 5)),
        "instancenorm_scale": (lambda p: p.gluon.nn.InstanceNorm(
            scale=True), (2, 3, 7)),
        "leakyrelu": (lambda p: p.gluon.nn.LeakyReLU(0.1), (3, 5)),
        "prelu": (lambda p: p.gluon.nn.PReLU(), (3, 5)),
        "elu": (lambda p: p.gluon.nn.ELU(0.7), (3, 5)),
        "selu": (lambda p: p.gluon.nn.SELU(), (3, 5)),
        "swish": (lambda p: p.gluon.nn.Swish(1.5), (3, 5)),
        "gelu": (lambda p: p.gluon.nn.GELU(), (3, 5)),
        "hybridlambda_name": (lambda p: p.gluon.nn.HybridLambda("tanh"),
                              (3, 5)),
        "hybridlambda_fn": (lambda p: p.gluon.nn.HybridLambda(
            lambda F, x: F.relu(x) * 2 + 1), (3, 5)),
        "conv1d": (lambda p: p.gluon.nn.Conv1D(4, 3, strides=2, padding=1,
                                               dilation=1), (2, 3, 9)),
        "conv3d": (lambda p: p.gluon.nn.Conv3D(2, (2, 3, 2), padding=1,
                                               use_bias=False),
                   (1, 3, 4, 5, 3)),
        "conv1d_transpose": (lambda p: p.gluon.nn.Conv1DTranspose(
            3, 3, strides=2, padding=1, output_padding=1), (2, 4, 5)),
        "conv2d_transpose": (lambda p: p.gluon.nn.Conv2DTranspose(
            4, (3, 2), strides=(2, 1), padding=(1, 0), groups=2,
            activation="relu"), (2, 4, 5, 4)),
        "conv3d_transpose": (lambda p: p.gluon.nn.Conv3DTranspose(
            2, 2, strides=2), (1, 3, 2, 3, 2)),
        "maxpool1d": (lambda p: p.gluon.nn.MaxPool1D(3, 2, padding=1,
                                                     ceil_mode=True),
                      (2, 3, 8)),
        "maxpool3d": (lambda p: p.gluon.nn.MaxPool3D(2), (1, 2, 4, 5, 4)),
        "avgpool1d": (lambda p: p.gluon.nn.AvgPool1D(3, 1, padding=1),
                      (2, 3, 6)),
        "avgpool2d": (lambda p: p.gluon.nn.AvgPool2D(3, 1, padding=1),
                      (2, 3, 7, 7)),
        "avgpool2d_exclude_pad_ceil": (lambda p: p.gluon.nn.AvgPool2D(
            3, 2, padding=1, ceil_mode=True, count_include_pad=False),
            (2, 3, 6, 7)),
        "avgpool3d": (lambda p: p.gluon.nn.AvgPool3D(2, padding=1,
                                                     ceil_mode=True),
                      (1, 2, 3, 4, 5)),
        "globalmaxpool1d": (lambda p: p.gluon.nn.GlobalMaxPool1D(),
                            (2, 3, 6)),
        "globalmaxpool2d": (lambda p: p.gluon.nn.GlobalMaxPool2D(),
                            (2, 3, 4, 5)),
        "globalmaxpool3d": (lambda p: p.gluon.nn.GlobalMaxPool3D(),
                            (1, 2, 3, 4, 2)),
        "globalavgpool1d": (lambda p: p.gluon.nn.GlobalAvgPool1D(),
                            (2, 3, 6)),
        "globalavgpool3d": (lambda p: p.gluon.nn.GlobalAvgPool3D(),
                            (1, 2, 3, 4, 2)),
        "reflectionpad2d": (lambda p: p.gluon.nn.ReflectionPad2D(2),
                            (2, 3, 5, 4)),
    }[name]


LAYERS = ["layernorm", "layernorm_axis1", "instancenorm",
          "instancenorm_scale", "leakyrelu", "prelu", "elu", "selu", "swish",
          "gelu", "hybridlambda_name", "hybridlambda_fn", "conv1d", "conv3d",
          "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
          "maxpool1d", "maxpool3d", "avgpool1d", "avgpool2d",
          "avgpool2d_exclude_pad_ceil", "avgpool3d", "globalmaxpool1d",
          "globalmaxpool2d", "globalmaxpool3d", "globalavgpool1d",
          "globalavgpool3d", "reflectionpad2d"]


def _twin(make, shape):
    with mx.name.NameManager():
        ref = make(mx)
    with tmx.name.NameManager():
        port = make(tmx)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    with _key_scope():
        ref(mx.nd.zeros(shape))
    port(tmx.nd.zeros(shape))
    assert list(port.collect_params()) == list(ref.collect_params())
    gluon_params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                   ref.collect_params().items()})
    return ref, port


def _layer_grads(pkg, net, x, head):
    """(output, input gradient, {name: parameter gradient}) of one
    recorded forward and the backward of sum(out * head)."""
    xin = pkg.nd.array(x)
    xin.attach_grad()
    with pkg.autograd.record():
        out = net(xin)
        loss = (out * pkg.nd.array(head)).sum()
    loss.backward()
    return (out.asnumpy(), xin.grad.asnumpy(),
            {n: p.grad().asnumpy().copy() for n, p in
             net.collect_params().items() if p.grad_req != "null"})


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_reference(name):
    make, shape = _layer(name)
    ref, port = _twin(make, shape)
    x = _rand(*shape, seed=1)
    with _key_scope():
        head = _rand(*ref(mx.nd.array(x)).shape, seed=2)
        want = _layer_grads(mx, ref, x, head)
    got = _layer_grads(tmx, port, x, head)
    tol = _EXACT if "pool" in name or "pad" in name else _FWD
    np.testing.assert_allclose(got[0], want[0], **tol)
    np.testing.assert_allclose(got[1], want[1],
                               **(tol if tol is _EXACT else _GRAD))
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], err_msg=n,
                                   **_GRAD)


@pytest.mark.parametrize("name", LAYERS)
def test_layer_hybridized_equals_eager(name):
    make, shape = _layer(name)
    with tmx.name.NameManager():
        net = make(tmx)
    net.initialize(tmx.init.Xavier())
    x = _rand(*shape, seed=3)
    net(tmx.nd.array(x))
    head = _rand(*net(tmx.nd.array(x)).shape, seed=4)
    eager = _layer_grads(tmx, net, x, head)
    net.hybridize()
    hybrid = _layer_grads(tmx, net, x, head)
    assert net._cached_graph is not None
    for a, b in zip(hybrid[:2], eager[:2]):
        np.testing.assert_allclose(a, b, **_EXACT)
    for n in eager[2]:
        np.testing.assert_allclose(hybrid[2][n], eager[2][n], **_EXACT)


def test_lambda_and_prelu_parameter():
    """Lambda wraps an nd function (by name too) and stays eager; PReLU's
    alpha starts at 0.25 on the net's context and takes a gradient."""
    lam = tmx.gluon.nn.Lambda("tanh")
    x = _rand(3, 4, seed=5)
    np.testing.assert_allclose(lam(tmx.nd.array(x)).asnumpy(), np.tanh(x),
                               **_EXACT)
    lam2 = tmx.gluon.nn.Lambda(lambda a, b: a * b)
    np.testing.assert_allclose(
        lam2(tmx.nd.array(x), tmx.nd.array(x)).asnumpy(), x * x, **_EXACT)
    with tmx.name.NameManager():
        prelu = tmx.gluon.nn.PReLU()
    prelu.initialize()
    assert list(prelu.collect_params()) == ["prelu0_alpha"]
    alpha = prelu.alpha.data()
    assert alpha.context == tmx.cpu() and alpha.asnumpy().tolist() == [0.25]
    xin = tmx.nd.array(x)
    with tmx.autograd.record():
        y = prelu(xin).sum()
    y.backward()
    np.testing.assert_allclose(prelu.alpha.grad().asnumpy(),
                               [x[x < 0].sum()], **_FWD)


def _with_constant(pkg):
    class AddConst(pkg.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.const = self.params.get_constant(
                    "const", [[1.0, -2.0, 0.5]])

        def hybrid_forward(self, F, x, const):
            return F.broadcast_add(x * 2, const)

    return AddConst()


def test_constant_matches_reference():
    """gluon.Constant (ParameterDict.get_constant): its value whatever
    the initializer, no gradient, and the block's output and input
    gradient against the reference's, eager and hybridized."""
    x = _rand(4, 3, seed=6)
    outs = {}
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            net = _with_constant(pkg)
        net.initialize(pkg.init.Xavier())
        const = net.collect_params()["addconst0_const"]
        assert isinstance(const, pkg.gluon.Constant)
        assert const.grad_req == "null"
        np.testing.assert_array_equal(const.data().asnumpy(),
                                      [[1.0, -2.0, 0.5]])
        xin = pkg.nd.array(x)
        xin.attach_grad()
        with pkg.autograd.record():
            y = net(xin)
        y.backward()
        outs[pkg] = (y.asnumpy(), xin.grad.asnumpy())
    for a, b in zip(outs[tmx], outs[mx]):
        np.testing.assert_allclose(a, b, **_EXACT)
    with tmx.name.NameManager():
        net = _with_constant(tmx)
    net.initialize(tmx.init.Xavier())
    net.hybridize()
    np.testing.assert_allclose(net(tmx.nd.array(x)).asnumpy(), outs[tmx][0],
                               **_EXACT)
    assert net._cached_graph is not None
    with pytest.raises(KeyError):
        net.params.get_constant("missing")
