"""Port parity for the creation ops (`_zeros`, `_ones`, `_full`,
`_arange`, `_eye`) and `where`, `argmax`, `norm`, `broadcast_to`,
`slice_axis`, `tile`, `one_hot` (mxnet_tpu_torch.ops.tensor), their
`nd.*` / `sym.*` functions and NDArray methods, against the JAX reference
on the CPU.

Also the port's part the reference lacks: a creation node whose shape
holds a 0 (`sym.zeros((L, 0, H))`, FusedRNNCell's begin states) gets that
dim from the bound data, and is made on the executor's device.

Inputs are numpy arrays from a seed; reference gradients come from its
autograd inside `trace_key_scope`. Tolerances: creation values, indices,
shapes and dtypes exact; float32 values and gradients 1e-5.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _same(got, want, exact=True):
    got, want = got.asnumpy(), np.asarray(want.asnumpy())
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **_TOL)


@pytest.mark.parametrize("op,kw", [
    ("_zeros", dict(shape=(2, 3))),
    ("_zeros", dict(shape=(4,), dtype="int32")),
    ("_ones", dict(shape=(3, 1, 2))),
    ("_ones", dict(shape=(2,), dtype="float16")),
    ("_full", dict(shape=(2, 2), value=2.5)),
    ("_full", dict(shape=(3,), value=7, dtype="int32")),
    ("_arange", dict(start=5)),
    ("_arange", dict(start=1, stop=4, step=0.5)),
    ("_arange", dict(start=0, stop=6, step=2, repeat=3)),
    ("_arange", dict(start=2, stop=9, dtype="int32")),
    ("_eye", dict(N=3)),
    ("_eye", dict(N=3, M=5, k=1)),
    ("_eye", dict(N=4, M=2, k=-1)),
])
def test_creation_op(op, kw):
    _same(getattr(tmx.nd, op)(**kw), getattr(mx.nd, op)(**kw))


def test_nd_creation_functions():
    _same(tmx.nd.arange(2, 11, 3), mx.nd.arange(2, 11, 3))
    _same(tmx.nd.arange(4, repeat=2), mx.nd.arange(4, repeat=2))
    _same(tmx.nd.eye(3, 4, 1), mx.nd.eye(3, 4, 1))
    _same(tmx.nd.eye(2, dtype="int32"), mx.nd.eye(2, dtype="int32"))
    _same(tmx.nd.full((2, 3), 0.25), mx.nd.full((2, 3), 0.25))
    _same(tmx.nd.zeros(5), mx.nd.zeros(5))
    _same(tmx.nd.ones((2, 2)), mx.nd.ones((2, 2)))
    assert tmx.nd.arange(3, ctx=tmx.cpu()).context == tmx.cpu()


@pytest.mark.parametrize("fn", ["zeros", "ones", "full", "arange", "eye"])
def test_sym_creation_functions(fn):
    args = {"zeros": ((2, 3),), "ones": ((4,),), "full": ((2, 2), 1.5),
            "arange": (1, 7, 2), "eye": (3, 4, 1)}[fn]
    x_ref, x_port = mx.sym.Variable("x"), tmx.sym.Variable("x")
    ref = getattr(mx.sym, fn)(*args) + 0.0
    port = getattr(tmx.sym, fn)(*args) + 0.0
    assert port.list_arguments() == ref.list_arguments() == []
    with _ref_scope():
        want = ref.eval(ctx=mx.cpu())[0]
    got = port.eval(ctx=tmx.cpu())[0]
    _same(got, want)
    assert x_ref.list_arguments() == x_port.list_arguments()


def _grads(pkg, fn, arrays):
    """(output, [gradient of sum(output * w) for each input]) through the
    package's autograd, w a fixed pattern of the output's shape."""
    nds = [pkg.nd.array(a) for a in arrays]
    for a in nds:
        a.attach_grad()
    with pkg.autograd.record():
        out = fn(pkg.nd, *nds)
        w = pkg.nd.array(np.linspace(-1, 1, int(np.prod(out.shape)))
                         .reshape(out.shape).astype(np.float32))
        total = (out * w).sum()
    total.backward()
    return out, [a.grad for a in nds]


_DIFF_CASES = {
    "where": (lambda nd, c, x, y: nd.where(c, x, y), [(3, 4), (3, 4),
                                                      (3, 4)]),
    "norm_all": (lambda nd, x: nd.norm(x), [(3, 4)]),
    "norm_axis": (lambda nd, x: nd.norm(x, axis=1, keepdims=True),
                  [(2, 3, 4)]),
    "norm_l1": (lambda nd, x: nd.norm(x, ord=1, axis=(0, 2)), [(2, 3, 4)]),
    "broadcast_to": (lambda nd, x: nd.broadcast_to(x, shape=(2, 0, 4)),
                     [(1, 3, 4)]),
    "slice_axis": (lambda nd, x: nd.slice_axis(x, axis=1, begin=1, end=3),
                   [(2, 5, 3)]),
    "slice_axis_neg": (lambda nd, x: nd.slice_axis(x, axis=-1, begin=-2,
                                                   end=None), [(2, 5, 3)]),
    "tile": (lambda nd, x: nd.tile(x, reps=(2, 1, 3)), [(2, 3)]),
}


@pytest.mark.parametrize("case", sorted(_DIFF_CASES))
def test_differentiable_op(case):
    fn, shapes = _DIFF_CASES[case]
    rng = np.random.RandomState(7)
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    if case == "where":
        arrays[0] = (arrays[0] > 0).astype(np.float32)
    with _ref_scope():
        ref_out, ref_grads = _grads(mx, fn, arrays)
    out, grads = _grads(tmx, fn, arrays)
    _same(out, ref_out, exact=False)
    for g, w in zip(grads[1:] if case == "where" else grads,
                    ref_grads[1:] if case == "where" else ref_grads):
        _same(g, w, exact=False)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           (1, True), (-1, False)])
def test_argmax(axis, keepdims):
    x = np.random.RandomState(2).randn(3, 5, 4).astype(np.float32)
    kw = {} if axis is None else dict(axis=axis, keepdims=keepdims)
    _same(tmx.nd.argmax(tmx.nd.array(x), **kw),
          mx.nd.argmax(mx.nd.array(x), **kw))
    _same(tmx.nd.array(x).argmax(**kw), mx.nd.array(x).argmax(**kw))


@pytest.mark.parametrize("kw", [dict(depth=5), dict(depth=4, on_value=3.0,
                                                    off_value=-1.0),
                                dict(depth=6, dtype="int32")])
def test_one_hot(kw):
    idx = np.array([[0, 3, 4], [1, -1, 7]], np.float32)  # -1, 7 off range
    _same(tmx.nd.one_hot(tmx.nd.array(idx), **kw),
          mx.nd.one_hot(mx.nd.array(idx), **kw))
    _same(tmx.nd.array(idx).one_hot(**kw), mx.nd.array(idx).one_hot(**kw))


def test_ndarray_methods_resolve():
    x = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    port, ref = tmx.nd.array(x), mx.nd.array(x)
    _same(port.tile(reps=(2,)), ref.tile(reps=(2,)))
    _same(port.norm(), ref.norm(), exact=False)
    _same(port[0:1].broadcast_to(shape=(4, 0)),
          ref[0:1].broadcast_to(shape=(4, 0)))
    _same(port.slice_axis(axis=0, begin=1, end=2),
          ref.slice_axis(axis=0, begin=1, end=2))


def test_where_in_a_symbol():
    """ZoneoutCell's use: where(mask, new, old) in a bound graph."""
    rng = np.random.RandomState(4)
    vals = {"c": (rng.rand(2, 3) > 0.5).astype(np.float32),
            "a": rng.randn(2, 3).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}
    outs = []
    for pkg in (mx, tmx):
        s = pkg.sym.where(pkg.sym.Variable("c"), pkg.sym.Variable("a"),
                          pkg.sym.Variable("b"))
        with _ref_scope():
            outs.append(s.eval(**{k: pkg.nd.array(v)
                                  for k, v in vals.items()})[0])
    _same(outs[1], outs[0])


def test_deferred_zeros_shape_from_bound_data():
    """A 0 in a creation node's shape is the batch of the bound data: an
    RNN over sym.zeros((2, 0, 6)) begin states binds at any batch, and
    the states are made on the executor's device."""
    data = tmx.sym.Variable("data")
    x = tmx.sym.transpose(tmx.sym.Embedding(data, input_dim=10,
                                            output_dim=4, name="e"),
                          axes=(1, 0, 2))
    net = tmx.sym.RNN(x, tmx.sym.Variable("p"), tmx.sym.zeros((2, 0, 6)),
                      tmx.sym.zeros((2, 0, 6)), state_size=6, num_layers=2,
                      mode="lstm", name="l")
    assert net.list_arguments() == ["data", "e_weight", "p"]
    for batch in (3, 5):
        args, outs, _ = net.infer_shape(data=(batch, 7))
        assert outs == [(7, batch, 6)]
        ex = net.simple_bind(tmx.cpu(), data=(batch, 7))
        ex.arg_dict["e_weight"][:] = 0.1
        ex.arg_dict["p"][:] = 0.01
        out = ex.forward(is_train=True)[0]
        assert out.shape == (7, batch, 6)
        ex.backward()
        assert ex.grad_dict["p"].shape == args[2]
    # without data the 0 stays a 0, as the reference's zero-size array
    _same(tmx.sym.zeros((0, 3)).eval(ctx=tmx.cpu())[0],
          mx.sym.zeros((0, 3)).eval(ctx=mx.cpu())[0])


def test_creation_op_takes_the_device_it_is_given():
    t = tmx.ops.registry.get("_zeros").fn(shape=(2, 0, 3), device="meta")
    assert t.device.type == "meta" and t.shape == (2, 0, 3)
    assert tmx.ops.registry.get("_arange").creation
    assert not tmx.ops.registry.get("where").creation
    e = tmx.ops.registry.get("_eye").fn(N=2, device=torch.device("cpu"))
    assert e.device.type == "cpu"
