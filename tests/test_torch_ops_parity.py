"""Port parity for op defaults, integer dtypes and Gluon's re-exports
against the JAX reference on the CPU.

Mirrors tests/test_operator.py::test_scalar_ops, tests/test_ndarray.py::
test_reduce_methods and tests/test_gluon.py::test_split_and_load, and
holds the port to the reference where they differed:
- the scalar ops called without a scalar take the reference's default
  (1.0 for _mul/_div/_rdiv/_power/_rpower_scalar, 0.0 for the rest);
- on integer data `sum` keeps int32, `mean`, `softmax`, `log_softmax` and
  `softrelu` return float32;
- `gluon.split_and_load` / `gluon.split_data` are re-exported, and
  `NDArray.split` splits as the reference's does.

Inputs are numpy arrays from a seed. Tolerances: elementwise float32
arithmetic 1e-6 (the same operations), exp/log-based functions 1e-5
(libm differences), integer results and shapes exact; dtypes must match.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

_EXACT = dict(rtol=1e-6, atol=1e-6)
_TRANS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _uniform(*shape, seed=0, lo=0.1, hi=0.9):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _ints(*shape, seed=0):
    return np.random.RandomState(seed).randint(-9, 10, shape) \
        .astype(np.int32)


def _both(fn, *arrays, dtype=None):
    """fn(package's nd, *NDArrays) in the reference and in the port, as
    numpy arrays."""
    kw = {} if dtype is None else {"dtype": dtype}
    ref = fn(mx.nd, *(mx.nd.array(a, **kw) for a in arrays))
    port = fn(tmx.nd, *(tmx.nd.array(a, **kw) for a in arrays))
    return ref.asnumpy(), port.asnumpy()


@pytest.mark.parametrize("op", ["_plus_scalar", "_minus_scalar",
                                "_rminus_scalar", "_mul_scalar",
                                "_div_scalar", "_rdiv_scalar",
                                "_power_scalar", "_rpower_scalar",
                                "_maximum_scalar", "_minimum_scalar"])
def test_scalar_op_default(op):
    x = _uniform(2, 3, 4, 5)
    ref, port = _both(lambda nd, a: getattr(nd, op)(a), x)
    np.testing.assert_allclose(port, ref, **_EXACT)


@pytest.mark.parametrize("op,scalar", [("_mul_scalar", 3.0),
                                       ("_div_scalar", 0.5),
                                       ("_rdiv_scalar", 2.0),
                                       ("_power_scalar", 2.0),
                                       ("_rpower_scalar", 1.5)])
def test_scalar_op_given(op, scalar):
    x = _uniform(3, 4, seed=1)
    ref, port = _both(lambda nd, a: getattr(nd, op)(a, scalar=scalar), x)
    np.testing.assert_allclose(port, ref, **_TRANS)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           (1, True), ((0, 2), False)])
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_integer_reduce(op, axis, keepdims):
    x = _ints(2, 3, 4, seed=3)
    ref, port = _both(lambda nd, a: getattr(nd, op)(a, axis=axis,
                                                    keepdims=keepdims),
                      x, dtype="int32")
    assert port.dtype == ref.dtype, (op, port.dtype, ref.dtype)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **_EXACT)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_integer_reduce_method(op):
    x = _ints(2, 3, 4, seed=4)
    ref, port = _both(lambda nd, a: getattr(a, op)(axis=1), x,
                      dtype="int32")
    assert port.dtype == ref.dtype, (op, port.dtype, ref.dtype)
    np.testing.assert_allclose(port, ref, **_EXACT)


_ACTIVATIONS = {
    "softmax": lambda nd, a: nd.softmax(a, axis=-1),
    "log_softmax": lambda nd, a: nd.log_softmax(a, axis=1),
    "softrelu": lambda nd, a: nd.softrelu(a),
    "Activation_softrelu": lambda nd, a: nd.Activation(
        a, act_type="softrelu"),
}


@pytest.mark.parametrize("name", sorted(_ACTIVATIONS))
def test_integer_activation(name):
    x = _ints(2, 3, 4, seed=5)
    ref, port = _both(_ACTIVATIONS[name], x, dtype="int32")
    assert port.dtype == ref.dtype == np.float32, (name, port.dtype)
    np.testing.assert_allclose(port, ref, **_TRANS)


@pytest.mark.parametrize("batch_axis,even", [(0, True), (1, False)])
def test_split_and_load(batch_axis, even):
    x = _uniform(8, 5, 3, seed=6)
    ref = mx.gluon.split_and_load(mx.nd.array(x), [mx.cpu(0), mx.cpu(1)],
                                  batch_axis=batch_axis, even_split=even)
    port = tmx.gluon.split_and_load(tmx.nd.array(x),
                                    [tmx.cpu(0), tmx.cpu(1)],
                                    batch_axis=batch_axis, even_split=even)
    assert len(port) == len(ref) == 2
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())


@pytest.mark.parametrize("num_slice,batch_axis,even", [(4, 0, True),
                                                       (2, 1, False)])
def test_split_data(num_slice, batch_axis, even):
    x = _uniform(8, 5, seed=7)
    ref = mx.gluon.split_data(mx.nd.array(x), num_slice, batch_axis, even)
    port = tmx.gluon.split_data(tmx.nd.array(x), num_slice, batch_axis,
                                even)
    assert [p.shape for p in port] == [r.shape for r in ref]
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())


@pytest.mark.parametrize("num_outputs,axis,squeeze", [(2, 0, False),
                                                      (3, 1, False),
                                                      (4, 2, True)])
def test_ndarray_split_method(num_outputs, axis, squeeze):
    x = _uniform(4, 6, 4, seed=8)
    ref = mx.nd.array(x).split(num_outputs=num_outputs, axis=axis,
                               squeeze_axis=squeeze)
    port = tmx.nd.array(x).split(num_outputs=num_outputs, axis=axis,
                                 squeeze_axis=squeeze)
    assert len(port) == len(ref) == num_outputs
    for r, p in zip(ref, port):
        assert p.shape == r.shape
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_pooling_without_spatial_axes(pool_type):
    """F13: Pooling of an input with no spatial axis (a (3, 4) array at
    the default kernel) gives the input back, as the reference's
    reduce_window over an empty window does."""
    x = _uniform(3, 4, seed=7)
    ref, port = _both(lambda nd, a: nd.Pooling(a, pool_type=pool_type), x)
    assert port.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(port, ref, **_EXACT)
    np.testing.assert_allclose(port, x, **_EXACT)
