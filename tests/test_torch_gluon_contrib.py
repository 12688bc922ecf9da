"""Port parity for Gluon contrib (mxnet_tpu_torch/gluon/contrib/) against
the JAX reference on the CPU, mirroring tests/test_gluon_contrib.py:
Concurrent, HybridConcurrent (eager and hybridized, the concatenation a
node of the cached graph) and Identity; VariationalDropoutCell (one mask
for every step in training, the identity at inference); the nine
convolutional cells Conv{1,2,3}D{RNN,LSTM,GRU}Cell and LSTMPCell, each
unrolled over 3 steps against the reference with the same weights
(outputs, states and gradients), and hybridized against eager;
IntervalSampler; WikiText2 and WikiText103 from their synthetic corpus
(vocabulary and windows equal to the reference's) and from a token file.

Tolerances, float32: outputs and states within 1e-5, gradients within
1e-4 (convolutions summed in another order).
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import gluon_params_from_numpy

_FWD = dict(rtol=1e-5, atol=1e-5)
_GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _key_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _concurrent(pkg, hybrid):
    gc = pkg.gluon.contrib.nn
    net = gc.HybridConcurrent(axis=1) if hybrid else gc.Concurrent(axis=-1)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(4))
        net.add(pkg.gluon.nn.Dense(6, activation="tanh"))
        net.add(gc.Identity())
    return net


@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_matches_reference(hybrid):
    with mx.name.NameManager():
        ref = _concurrent(mx, hybrid)
    with tmx.name.NameManager():
        port = _concurrent(tmx, hybrid)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    x = _rand(2, 3, seed=1)
    ref(mx.nd.array(x))
    port(tmx.nd.array(x))
    assert list(port.collect_params()) == list(ref.collect_params())
    gluon_params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                   ref.collect_params().items()})
    got = port(tmx.nd.array(x)).asnumpy()
    assert got.shape == (2, 4 + 6 + 3)
    np.testing.assert_allclose(got, ref(mx.nd.array(x)).asnumpy(), **_FWD)
    np.testing.assert_array_equal(got[:, -3:], x)


def test_hybrid_concurrent_hybridized_equals_eager():
    """The reference's test_gluon_contrib.py:25: hybridized outputs equal
    eager ones; in the port the cached graph holds one Concat node over
    the branches, and gradients match too."""
    with tmx.name.NameManager():
        net = _concurrent(tmx, True)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_rand(3, 5, seed=2))
    res = []
    for hybridize in (False, True):
        if hybridize:
            net.hybridize()
        with tmx.autograd.record():
            y = net(x)
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), {n: p.grad().asnumpy().copy() for n, p in
                                  net.collect_params().items()}))
    assert net._cached_graph is not None
    graph = net._cached_graph[1][0]
    assert [n.op.name for n in graph._topo() if n.op is not None].count(
        "Concat") == 1
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6, atol=1e-6)
    for n in res[0][1]:
        np.testing.assert_allclose(res[1][1][n], res[0][1][n], rtol=1e-6,
                                   atol=1e-6)


def test_variational_dropout_cell():
    base = tmx.gluon.rnn.LSTMCell(8)
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=0.5, drop_states=0.5)
    cell.initialize(tmx.init.Xavier())
    x = tmx.nd.ones((4, 6, 3))
    with tmx.autograd.record():
        out, states = cell.unroll(6, x, merge_outputs=True)
    assert out.shape == (4, 6, 8)
    assert np.isfinite(out.asnumpy()).all()
    mask = cell._input_mask.asnumpy()
    assert (mask == 0).any() and (mask != 0).any(), mask
    cell.reset()
    o1, _ = cell.unroll(6, x, merge_outputs=True)
    cell.reset()
    o2, _ = cell.unroll(6, x, merge_outputs=True)
    np.testing.assert_array_equal(o1.asnumpy(), o2.asnumpy())


def test_variational_dropout_cell_at_inference_matches_reference():
    res = {}
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            cell = pkg.gluon.contrib.rnn.VariationalDropoutCell(
                pkg.gluon.rnn.GRUCell(5, input_size=3), drop_inputs=0.3,
                drop_states=0.2, drop_outputs=0.4)
        cell.initialize(pkg.init.Xavier())
        res[pkg] = cell
    gluon_params_from_numpy(res[tmx], {
        n: p.data().asnumpy() for n, p in res[mx].collect_params().items()})
    x = _rand(2, 4, 3, seed=3)
    with _key_scope():
        want = res[mx].unroll(4, mx.nd.array(x), merge_outputs=True)[0]
    got = res[tmx].unroll(4, tmx.nd.array(x), merge_outputs=True)[0]
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **_FWD)


_CONV_CELLS = {
    "Conv1DRNNCell": ((3, 10), dict(hidden_channels=5, i2h_kernel=3,
                                    h2h_kernel=3, i2h_pad=1)),
    "Conv2DRNNCell": ((3, 6, 5), dict(hidden_channels=4, i2h_kernel=3,
                                      h2h_kernel=3, i2h_pad=1)),
    "Conv3DRNNCell": ((2, 4, 3, 4), dict(hidden_channels=3, i2h_kernel=3,
                                         h2h_kernel=3, i2h_pad=1,
                                         activation="relu")),
    "Conv1DLSTMCell": ((3, 9), dict(hidden_channels=4, i2h_kernel=2,
                                    h2h_kernel=3)),
    "Conv2DLSTMCell": ((3, 6, 6), dict(hidden_channels=4, i2h_kernel=3,
                                       h2h_kernel=5, i2h_pad=1,
                                       h2h_dilate=2)),
    "Conv3DLSTMCell": ((2, 4, 4, 3), dict(hidden_channels=3, i2h_kernel=3,
                                          h2h_kernel=3, i2h_pad=1)),
    "Conv1DGRUCell": ((3, 10), dict(hidden_channels=5, i2h_kernel=3,
                                    h2h_kernel=3, i2h_pad=1)),
    "Conv2DGRUCell": ((3, 5, 6), dict(hidden_channels=4, i2h_kernel=3,
                                      h2h_kernel=3, i2h_pad=2,
                                      i2h_dilate=2)),
    "Conv3DGRUCell": ((2, 3, 4, 4), dict(hidden_channels=3, i2h_kernel=3,
                                         h2h_kernel=3, i2h_pad=1)),
    "LSTMPCell": ((10,), dict(hidden_size=16, projection_size=6)),
}


def _contrib_cell(pkg, name):
    shape, kw = _CONV_CELLS[name]
    cls = getattr(pkg.gluon.contrib.rnn, name)
    if name == "LSTMPCell":
        return cls(input_size=shape[0], **kw)
    return cls(input_shape=shape, **kw)


def _unrolled(pkg, cell, x):
    """(outputs, states, input gradient, {name: parameter gradient}) of a
    3-step NTC unroll under record and the backward of sum(outputs *
    head)."""
    xin = pkg.nd.array(x)
    xin.attach_grad()
    with pkg.autograd.record():
        outs, states = cell.unroll(3, xin, merge_outputs=True)
        head = pkg.nd.array(_rand(*outs.shape, seed=12))
        loss = (outs * head).sum()
    loss.backward()
    return (outs.asnumpy(), [s.asnumpy() for s in states],
            xin.grad.asnumpy(),
            {n: p.grad().asnumpy().copy()
             for n, p in cell.collect_params().items()})


@pytest.mark.parametrize("name", sorted(_CONV_CELLS))
def test_contrib_cell_matches_reference(name):
    with mx.name.NameManager():
        ref = _contrib_cell(mx, name)
    with tmx.name.NameManager():
        port = _contrib_cell(tmx, name)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    assert list(port.collect_params()) == list(ref.collect_params())
    gluon_params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                   ref.collect_params().items()})
    x = _rand(2, 3, *_CONV_CELLS[name][0], seed=4)
    want = _unrolled(mx, ref, x)
    got = _unrolled(tmx, port, x)
    np.testing.assert_allclose(got[0], want[0], **_FWD)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **_FWD)
    np.testing.assert_allclose(got[2], want[2], **_GRAD)
    for n in want[3]:
        np.testing.assert_allclose(got[3][n], want[3][n], err_msg=n,
                                   **_GRAD)
    assert float(np.abs(got[3][port.prefix + "i2h_weight"]).sum()) > 0


@pytest.mark.parametrize("name", ["Conv2DLSTMCell", "Conv1DGRUCell",
                                  "LSTMPCell"])
def test_contrib_cell_hybridized_equals_eager(name):
    with tmx.name.NameManager():
        cell = _contrib_cell(tmx, name)
    cell.initialize(tmx.init.Xavier())
    x = _rand(2, 3, *_CONV_CELLS[name][0], seed=5)
    eager = _unrolled(tmx, cell, x)
    cell.hybridize()
    hybrid = _unrolled(tmx, cell, x)
    assert cell._cached_graph is not None
    np.testing.assert_allclose(hybrid[0], eager[0], rtol=1e-6, atol=1e-6)
    for n in eager[3]:
        np.testing.assert_allclose(hybrid[3][n], eager[3][n], rtol=1e-6,
                                   atol=1e-6)


def test_conv_cell_shapes():
    """test_gluon_contrib.py:62's shapes: a step of each family and
    dimension, and the LSTMP states."""
    crnn = tmx.gluon.contrib.rnn
    cell = crnn.Conv2DRNNCell(input_shape=(3, 8, 8), hidden_channels=4,
                              i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    cell.initialize()
    out, new = cell(tmx.nd.array(_rand(2, 3, 8, 8)),
                    cell.begin_state(batch_size=2))
    assert out.shape == (2, 4, 8, 8) and len(new) == 1
    lstm = crnn.Conv3DLSTMCell(input_shape=(2, 4, 4, 4), hidden_channels=3,
                               i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    lstm.initialize()
    out, new = lstm(tmx.nd.array(_rand(1, 2, 4, 4, 4)),
                    lstm.begin_state(batch_size=1))
    assert out.shape == (1, 3, 4, 4, 4) and len(new) == 2
    with pytest.raises(ValueError, match="odd"):
        crnn.Conv1DGRUCell(input_shape=(3, 10), hidden_channels=2,
                           i2h_kernel=3, h2h_kernel=2)
    lstmp = crnn.LSTMPCell(hidden_size=16, projection_size=6)
    lstmp.initialize()
    out, states = lstmp(tmx.nd.array(_rand(3, 10)),
                        lstmp.begin_state(batch_size=3))
    assert out.shape == (3, 6)
    assert states[0].shape == (3, 6) and states[1].shape == (3, 16)


def test_interval_sampler():
    from mxnet_tpu_torch.gluon.contrib.data import IntervalSampler
    assert list(IntervalSampler(10, 3)) == [0, 3, 6, 9, 1, 4, 7, 2, 5, 8]
    assert len(IntervalSampler(10, 3)) == 10
    assert list(IntervalSampler(10, 3, rollover=False)) == [0, 3, 6, 9]


@pytest.mark.parametrize("name", ["WikiText2", "WikiText103"])
def test_wikitext_synthetic_matches_reference(name, tmp_path):
    """Without the token files both packages build the same synthetic
    corpus: the same vocabulary, windows and labels."""
    root = str(tmp_path / "absent")
    ref = getattr(mx.gluon.contrib.data, name)(root=root, seq_len=35)
    port = getattr(tmx.gluon.contrib.data, name)(root=root, seq_len=35)
    assert len(port) == len(ref) > 100
    assert port.vocabulary.idx_to_token == ref.vocabulary.idx_to_token
    assert port.frequencies == ref.frequencies
    for i in (0, len(ref) // 2, len(ref) - 1):
        x, y = port[i]
        assert x.context == tmx.cpu()
        np.testing.assert_array_equal(x.asnumpy(), ref[i][0].asnumpy())
        np.testing.assert_array_equal(y.asnumpy(), ref[i][1].asnumpy())


def test_wikitext_windows_and_token_file(tmp_path):
    from mxnet_tpu_torch.gluon.contrib.data import WikiText2
    ds = WikiText2(root=str(tmp_path / "absent"), seq_len=35)
    fx = np.concatenate([ds[i][0].asnumpy() for i in range(3)])
    fy = np.concatenate([ds[i][1].asnumpy() for i in range(3)])
    np.testing.assert_array_equal(fx[1:], fy[:-1])
    val = WikiText2(root=str(tmp_path / "absent"), segment="validation",
                    vocab=ds.vocabulary)
    assert val.vocabulary is ds.vocabulary
    root = tmp_path / "wt2"
    root.mkdir()
    (root / "wiki.train.tokens").write_text("a b c\nd e f g\n")
    real = WikiText2(root=str(root), seq_len=4)
    assert len(real) == 2
    eos = real.vocabulary.token_to_idx["<eos>"]
    assert real[0][0].asnumpy()[3] == eos
    with pytest.raises(ValueError):
        WikiText2(root=str(root), segment="dev")
