"""Python custom ops on the port (mxnet_tpu_torch/operator.py,
ops/custom.py): `nd.Custom`, `sym.Custom` bound in an executor and in a
Module, a hybridized block that calls `F.Custom`, and the deprecated
NumpyOp / NDArrayOp adapters; examples/custom_op.py on the port.

The reference's imperative `nd.Custom` (its `operator.invoke`, recorded
on its autograd tape) is the oracle for forward values and input
gradients. Its symbolic path is not used as an oracle: three of
tests/test_custom_symbolic.py's cases fail on the reference itself (a
known reference-side failure). The graph paths are held to the port's
own `nd.Custom` on the same op and inputs, and the example's NumpySoftmax
head in a Module to the same Module with the built-in SoftmaxOutput
(normalization "batch"), whose gradient is the same function. Mirrors
tests/test_custom_symbolic.py and tests/test_misc.py's NumpyOp case.

Tolerances: 1e-6 (softmax in numpy on both sides, the same arithmetic);
the Module's parameters after five SGD steps 1e-5.
"""
import sys

import numpy as np
import pytest

import jax

import mxnet_tpu as mx
import mxnet_tpu.operator as ref_operator

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.operator as port_operator

from chip_smoke import load_example

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np_softmax(x):
    y = np.exp(x - x.max(axis=1, keepdims=True))
    return y / y.sum(axis=1, keepdims=True)


def _define(operator, pkg):
    """The test ops, registered in `operator`'s registry: a softmax with
    its full backward, a two-input difference, an op whose output shows
    the train flag, a two-output op, and one with an auxiliary state."""

    class Softmax(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], pkg.nd.array(_np_softmax(x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            gy = out_grad[0].asnumpy()
            gx = y * (gy - (gy * y).sum(axis=1, keepdims=True))
            self.assign(in_grad[0], req[0], pkg.nd.array(gx))

    @operator.register("_port_test_softmax")
    class SoftmaxProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Sub(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] - in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])
            self.assign(in_grad[1], req[1], -out_grad[0])

    @operator.register("_port_test_sub")
    class SubProp(operator.CustomOpProp):
        def list_arguments(self):
            return ["lhs", "rhs"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sub()

    class TrainFlag(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] + (1.0 if is_train else -1.0))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])

    @operator.register("_port_test_train_flag")
    class TrainFlagProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return TrainFlag()

    class Split(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)
            self.assign(out_data[1], req[1], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2
                        + out_grad[1] * 2 * in_data[0])

    @operator.register("_port_test_split")
    class SplitProp(operator.CustomOpProp):
        def list_outputs(self):
            return ["double", "square"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Split()

    class WithAux(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + aux[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])

    @operator.register("_port_test_aux")
    class WithAuxProp(operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            return WithAux()


_define(ref_operator, mx)
_define(port_operator, tmx)


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _nd_custom_and_grads(pkg, op_type, arrays, head):
    """(outputs, input gradients) of pkg.nd.Custom under autograd, the
    head gradients `head` on its outputs."""
    xs = [pkg.nd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.Custom(*xs, op_type=op_type)
    outs = out if isinstance(out, list) else [out]
    pkg.autograd.backward(outs, [pkg.nd.array(h) for h in head])
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("op_type,n_in,n_out", [
    ("_port_test_softmax", 1, 1), ("_port_test_sub", 2, 1),
    ("_port_test_split", 1, 2)])
def test_nd_custom_matches_the_reference(op_type, n_in, n_out):
    rs = np.random.RandomState(0)
    arrays = [rs.uniform(-1, 1, (4, 5)).astype(np.float32)
              for _ in range(n_in)]
    head = [rs.randn(4, 5).astype(np.float32) for _ in range(n_out)]
    with _ref_scope():
        r_out, r_grads = _nd_custom_and_grads(mx, op_type, arrays, head)
    p_out, p_grads = _nd_custom_and_grads(tmx, op_type, arrays, head)
    assert len(p_out) == len(r_out) == n_out
    for p, r in zip(p_out + p_grads, r_out + r_grads):
        np.testing.assert_allclose(p, r, **TOL)


def test_nd_custom_outside_record_and_its_aux_states():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = tmx.nd.Custom(tmx.nd.array(x), op_type="_port_test_softmax")
    np.testing.assert_allclose(y.asnumpy(), _np_softmax(x), **TOL)
    # nd.Custom gives an auxiliary state as zeros, as the reference does
    out = tmx.nd.Custom(tmx.nd.array(x), op_type="_port_test_aux")
    ref = mx.nd.Custom(mx.nd.array(x), op_type="_port_test_aux")
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), **TOL)
    # the graph path does not persist aux states, so it raises
    s = tmx.sym.Custom(tmx.sym.Variable("data"), op_type="_port_test_aux")
    ex = s.bind(tmx.cpu(), {"data": tmx.nd.array(x)}, grad_req="null")
    with pytest.raises(tmx.MXNetError, match="auxiliary states"):
        ex.forward()
    with pytest.raises(tmx.MXNetError, match="not registered"):
        tmx.nd.Custom(tmx.nd.array(x), op_type="_port_test_missing")


def test_executor_custom_forward_backward():
    """sym.Custom bound in an executor: forward and input gradient as
    the port's nd.Custom on the same op and inputs; inputs bind by the
    prop's declared arguments whatever the keyword order."""
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (4, 5)).astype(np.float32)
    gy = rs.randn(4, 5).astype(np.float32)
    s = tmx.sym.Custom(tmx.sym.Variable("data"),
                       op_type="_port_test_softmax")
    assert s.list_arguments() == ["data"]
    assert s.infer_shape(data=(4, 5))[1] == [(4, 5)]
    exe = s.simple_bind(tmx.cpu(), data=(4, 5))
    out = exe.forward(is_train=True, data=tmx.nd.array(x))[0].asnumpy()
    exe.backward(out_grads=tmx.nd.array(gy))
    want, grads = _nd_custom_and_grads(tmx, "_port_test_softmax", [x], [gy])
    np.testing.assert_allclose(out, want[0], **TOL)
    np.testing.assert_allclose(exe.grad_arrays[0].asnumpy(), grads[0], **TOL)

    a, b = tmx.sym.Variable("a"), tmx.sym.Variable("b")
    sub = tmx.sym.Custom(rhs=b, lhs=a, op_type="_port_test_sub")
    assert sub.list_arguments() == ["a", "b"]
    exe = sub.simple_bind(tmx.cpu(), a=(2,), b=(2,))
    got = exe.forward(is_train=False, a=tmx.nd.array([5.0, 5.0]),
                      b=tmx.nd.array([1.0, 2.0]))[0].asnumpy()
    np.testing.assert_allclose(got, [4.0, 3.0])

    split = tmx.sym.Custom(tmx.sym.Variable("data"),
                           op_type="_port_test_split", name="sp")
    assert split.list_outputs() == ["sp_output0", "sp_output1"]
    exe = split.simple_bind(tmx.cpu(), data=(4, 5))
    outs = exe.forward(is_train=False, data=tmx.nd.array(x))
    np.testing.assert_allclose(outs[1].asnumpy(), x * x, **TOL)


def test_executor_custom_sees_the_train_flag():
    s = tmx.sym.Custom(tmx.sym.Variable("data"),
                       op_type="_port_test_train_flag")
    exe = s.simple_bind(tmx.cpu(), data=(2, 2))
    x = tmx.nd.zeros((2, 2))
    np.testing.assert_allclose(exe.forward(is_train=True, data=x)[0]
                               .asnumpy(), np.ones((2, 2)))
    np.testing.assert_allclose(exe.forward(is_train=False, data=x)[0]
                               .asnumpy(), -np.ones((2, 2)))


class _Head(tmx.gluon.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.fc = tmx.gluon.nn.Dense(5)

    def hybrid_forward(self, F, x):
        return F.Custom(self.fc(x), op_type="_port_test_softmax")


@pytest.mark.parametrize("hybridize", [False, True])
def test_block_with_custom_op(hybridize):
    """A Gluon block whose hybrid_forward calls F.Custom, eager and
    hybridized (a traced graph evaluated with the op inside): the same
    output and parameter gradients."""
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (4, 3)).astype(np.float32)
    gy = rs.randn(4, 5).astype(np.float32)
    with tmx.name.NameManager():
        net = _Head()
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.array(x))
    w = net.fc.weight.data().asnumpy()
    b = net.fc.bias.data().asnumpy()
    if hybridize:
        net.hybridize()
    with tmx.autograd.record():
        out = net(tmx.nd.array(x))
    out.backward(tmx.nd.array(gy))
    if hybridize:
        assert net._cached_graph is not None
    logits = x @ w.T + b
    y = _np_softmax(logits)
    np.testing.assert_allclose(out.asnumpy(), y, **TOL)
    g_logits = y * (gy - (gy * y).sum(axis=1, keepdims=True))
    np.testing.assert_allclose(net.fc.weight.grad().asnumpy(),
                               g_logits.T @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(net.fc.bias.grad().asnumpy(),
                               g_logits.sum(0), rtol=1e-5, atol=1e-6)


def test_deprecated_numpy_and_ndarray_ops():
    class SquareOp(port_operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * in_data[0] * out_grad[0]

    class DoubleOp(port_operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0]._data = (in_data[0] * 2)._data

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0]._data = (out_grad[0] * 2)._data

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for op, f, df in ((SquareOp(), x ** 2, 2 * x),
                      (DoubleOp(), 2 * x, np.full_like(x, 2.0))):
        s = op.get_symbol(tmx.sym.Variable("data"))
        assert op.get_symbol(tmx.sym.Variable("data")).list_arguments() \
            == ["data"]
        exe = s.simple_bind(tmx.cpu(), data=(2, 3), grad_req="write")
        out = exe.forward(is_train=True, data=tmx.nd.array(x))[0].asnumpy()
        np.testing.assert_allclose(out, f, **TOL)
        exe.backward(out_grads=[tmx.nd.ones((2, 3))])
        np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(), df,
                                   **TOL)


def _mlp(sym, head):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu")
    fc2 = sym.FullyConnected(act, num_hidden=10, name="fc2")
    label = sym.Variable("softmax_label")
    if head == "custom":
        return sym.Custom(fc2, label, op_type="numpy_softmax",
                          name="softmax")
    return sym.SoftmaxOutput(fc2, label, normalization="batch",
                             name="softmax")


def test_example_numpy_softmax_through_module():
    """examples/custom_op.py's NumpySoftmax head in a Module: five SGD
    steps give the parameters the built-in SoftmaxOutput (normalization
    'batch', the same gradient) gives from the same start."""
    load_example("custom_op.py", tmx)         # registers numpy_softmax
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 1, (5, 32, 20)).astype(np.float32)
    y = rs.randint(0, 10, (5, 32)).astype(np.float32)
    params = {}
    for head in ("custom", "builtin"):
        with tmx.name.NameManager():
            mod = tmx.mod.Module(_mlp(tmx.sym, head), context=tmx.cpu(),
                                 label_names=["softmax_label"])
        mod.bind(data_shapes=[("data", (32, 20))],
                 label_shapes=[("softmax_label", (32,))])
        tmx.random.seed(0)
        np.random.seed(0)
        mod.init_params(tmx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        for i in range(5):
            batch = tmx.io.DataBatch(data=[tmx.nd.array(x[i])],
                                     label=[tmx.nd.array(y[i])])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        params[head] = {k: v.asnumpy() for k, v in mod.get_params()[0]
                        .items()}
    assert sorted(params["custom"]) == sorted(params["builtin"])
    for k, v in params["builtin"].items():
        np.testing.assert_allclose(params["custom"][k], v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_custom_op_example_runs_on_the_port(capsys):
    """examples/custom_op.py at its defaults (2 epochs of the synthetic
    MNIST, batch 64) on the port: main() returns 0 (validation accuracy
    >= 0.9)."""
    module = load_example("custom_op.py", tmx)
    argv = sys.argv
    sys.argv = ["custom_op.py"]
    try:
        np.random.seed(0)
        tmx.random.seed(0)
        rc = module.main()
    finally:
        sys.argv = argv
    assert rc == 0, capsys.readouterr()
