"""Port parity for the initializers ported with the symbolic RNN workflow
(mxnet_tpu_torch.initializer: MSRAPrelu, Orthogonal, Bilinear, LSTMBias,
FusedRNN, Load, Mixed, and the register / alias / create registry)
against the JAX reference on the CPU.

The reference draws from numpy's global generator and the port from its
own torch generator, so the random initializers are held to their
moments and structure: MSRAPrelu's standard deviation within 5 % of
sqrt(2 / (1 + slope^2) / fan) on 10^5 draws, Orthogonal's rows or
columns orthonormal to 1e-5 after dividing by `scale`. The deterministic
ones (Bilinear, LSTMBias, Load, Mixed's dispatch) equal the reference's
exactly. FusedRNN walks the `RNN` op's parameter layout (upstream's
rule; the reference's FusedRNN only delegates): its blocks are checked
against `ops.nn._unpack_rnn_params`, the layout the op reads.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.initializer import InitDesc, rnn_param_blocks
from mxnet_tpu_torch.ops.nn import _unpack_rnn_params, rnn_param_size


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _fill(init, name, shape):
    arr = tmx.nd.zeros(shape)
    init(InitDesc(name), arr)
    return arr.asnumpy()


def _ref_fill(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(mx.init.InitDesc(name), arr)
    return np.asarray(arr.asnumpy())


@pytest.mark.parametrize("factor_type,fan", [("avg", (200 + 500) / 2.0),
                                             ("in", 200), ("out", 500)])
def test_msraprelu_moments(factor_type, fan):
    slope = 0.25
    got = _fill(tmx.init.MSRAPrelu(factor_type, slope, seed=1),
                "fc_weight", (500, 200))
    want_std = np.sqrt(2.0 / (1 + slope ** 2) / fan)
    ref = _ref_fill(mx.init.MSRAPrelu(factor_type, slope), "fc_weight",
                    (500, 200))
    for arr in (got, ref):
        assert abs(arr.std() / want_std - 1) < 0.05
        assert abs(arr.mean()) < 0.05 * want_std
    assert tmx.init.MSRAPrelu().dumps() == mx.init.MSRAPrelu().dumps()


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (8, 2, 3, 3)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal(shape, rand_type):
    scale = 1.414
    got = _fill(tmx.init.Orthogonal(scale, rand_type), "w_weight", shape)
    ref = _ref_fill(mx.init.Orthogonal(scale, rand_type), "w_weight", shape)
    for arr in (got, ref):
        q = arr.reshape(shape[0], -1) / scale
        small = min(q.shape)
        gram = q @ q.T if q.shape[0] == small else q.T @ q
        np.testing.assert_allclose(gram, np.eye(small), atol=1e-5)
    other = _fill(tmx.init.Orthogonal(scale, rand_type, seed=1), "w_weight",
                  shape)
    assert not np.allclose(other, got)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (3, 2, 5, 5), (2, 1, 3, 6)])
def test_bilinear(shape):
    np.testing.assert_array_equal(
        _fill(tmx.init.Bilinear(), "up_weight", shape),
        _ref_fill(mx.init.Bilinear(), "up_weight", shape))


@pytest.mark.parametrize("forget_bias", [1.0, 0.5])
def test_lstm_bias(forget_bias):
    np.testing.assert_array_equal(
        _fill(tmx.init.LSTMBias(forget_bias), "lstm_i2h_bias", (16,)),
        _ref_fill(mx.init.LSTMBias(forget_bias), "lstm_i2h_bias", (16,)))


def test_mixed_dispatches_like_reference():
    """examples/lstm_bucketing.py's initializer: the flat LSTM vector by
    Uniform(0.1), the rest by Xavier (biases zero by name)."""
    init = tmx.init.Mixed([".*lstm_parameters", ".*"],
                          [tmx.init.Uniform(0.1), tmx.init.Xavier()])
    flat = _fill(init, "lstm_parameters", (5000,))
    assert np.abs(flat).max() <= 0.1 and flat.std() > 0.05
    w = _fill(init, "pred_weight", (32, 16))
    assert 0 < np.abs(w).max() <= np.sqrt(3.0 / 24)
    np.testing.assert_array_equal(_fill(init, "pred_bias", (32,)), 0)
    with pytest.raises(ValueError, match="no initializer matches"):
        _fill(tmx.init.Mixed(["a.*"], [tmx.init.One()]), "b_weight", (2,))
    ref = mx.init.Mixed(["a.*", ".*"], [mx.init.One(), mx.init.Zero()])
    port = tmx.init.Mixed(["a.*", ".*"], [tmx.init.One(), tmx.init.Zero()])
    for name in ("a_weight", "b_weight", "ab_bias"):
        np.testing.assert_array_equal(_fill(port, name, (3,)),
                                      _ref_fill(ref, name, (3,)))


def test_load_and_its_default():
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    params = {"arg:fc_weight": tmx.nd.array(w)}
    np.testing.assert_array_equal(
        _fill(tmx.init.Load(params), "fc_weight", (2, 3)), w)
    ref = _ref_fill(mx.init.Load({"arg:fc_weight": mx.nd.array(w)}),
                    "fc_weight", (2, 3))
    np.testing.assert_array_equal(ref, w)
    np.testing.assert_array_equal(
        _fill(tmx.init.Load(params, default_init=tmx.init.One()),
              "fc_scale", (3,)), 1)
    with pytest.raises(ValueError, match="fc_bias"):
        _fill(tmx.init.Load(params), "fc_bias", (3,))


@pytest.mark.parametrize("mode,layers,bidirectional", [
    ("lstm", 2, False), ("lstm", 1, True), ("gru", 2, True),
    ("rnn_tanh", 3, False)])
def test_fused_rnn_walks_the_op_layout(mode, layers, bidirectional):
    H, C = 5, 3
    size = rnn_param_size(layers, C, H, bidirectional, mode)
    init = tmx.init.FusedRNN(tmx.init.Xavier(), num_hidden=H,
                             num_layers=layers, mode=mode,
                             bidirectional=bidirectional, forget_bias=0.75)
    flat = _fill(init, "lstm_parameters", (size,))
    blocks = rnn_param_blocks(size, H, layers, mode, bidirectional)
    assert blocks[-1][1] + int(np.prod(blocks[-1][2])) == size
    unpacked = _unpack_rnn_params(torch.from_numpy(flat), layers, C, H,
                                  bidirectional, mode)
    G = {"lstm": 4, "gru": 3}.get(mode, 1)
    dirs = 2 if bidirectional else 1
    for li in range(layers):
        for di in range(dirs):
            wi, wh, bi, bh = (t.numpy() for t in unpacked[li][di])
            for w in (wi, wh):
                assert w.shape[0] == G * H
                for g in range(G):
                    block = w[g * H:(g + 1) * H]
                    bound = np.sqrt(6.0 / sum(block.shape))
                    assert 0 < np.abs(block).max() <= bound
            for b in (bi, bh):
                want = np.zeros(G * H, np.float32)
                if mode == "lstm":
                    want[H:2 * H] = 0.75
                np.testing.assert_array_equal(b, want)
    names = [n for n, _, _ in blocks]
    assert names[0] == "l0_i2h%s_weight" % ("_i" if mode == "lstm"
                                              else "_r" if mode == "gru"
                                              else "")
    assert any(n.startswith("r0_") for n in names) == bidirectional


def test_fused_rnn_by_json_and_without_hidden():
    init = tmx.init.FusedRNN('["uniform", {"scale": 0.2}]', num_hidden=4,
                             num_layers=1, mode="rnn_relu")
    flat = _fill(init, "p_parameters", (rnn_param_size(1, 2, 4, False,
                                                       "rnn_relu"),))
    assert np.abs(flat).max() <= 0.2
    whole = _fill(tmx.init.FusedRNN(tmx.init.One()), "p_parameters", (7,))
    np.testing.assert_array_equal(whole, 1)
    with pytest.raises(ValueError, match="do not fit"):
        _fill(tmx.init.FusedRNN(tmx.init.One(), num_hidden=4), "p", (7,))


def test_registry_create_alias_register():
    for name in ("zero", "zeros", "one", "ones", "constant", "uniform",
                 "normal", "xavier", "msraprelu", "orthogonal", "bilinear",
                 "lstmbias", "fusedrnn", "mixed", "load"):
        assert name in tmx.registry._REGISTRIES["initializer"], name
    init = tmx.init.create("msraprelu", slope=0.1)
    assert isinstance(init, tmx.init.MSRAPrelu)
    assert isinstance(tmx.init.create(init.dumps()), tmx.init.MSRAPrelu)
    assert tmx.init.create(init) is init

    @tmx.init.register
    @tmx.init.alias("halves")
    class Half(tmx.init.Initializer):
        def _init_weight(self, _, arr):
            self._set(arr, torch.full(arr.shape, 0.5))

    np.testing.assert_array_equal(
        _fill(tmx.init.create("halves"), "h_weight", (2,)), 0.5)
    np.testing.assert_array_equal(
        _fill(tmx.init.create("half"), "h_weight", (2,)), 0.5)
    # a variable's __init__ attribute names its initializer
    arr = tmx.nd.ones((3,))
    tmx.init.Xavier()(InitDesc("s_state", attrs={"__init__": "zeros"}), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 0)
    with pytest.raises(ValueError, match="unknown initializer"):
        tmx.init.create("no_such_initializer")
