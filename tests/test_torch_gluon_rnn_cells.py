"""Port parity for Gluon's recurrent cells (mxnet_tpu_torch/gluon/rnn/
rnn_cell.py) against the JAX reference on the CPU, mirroring
tests/test_gluon.py's cell tests (shapes, unroll, the stacked, dropout,
residual, zoneout and bidirectional cells) and holding each to the
reference: RNNCell (tanh and relu), LSTMCell and GRUCell stepped once and
unrolled over 5 steps in both layouts, merged and as lists, with and
without `valid_length`; SequentialRNNCell, DropoutCell (at inference),
ResidualCell, ZoneoutCell (at inference) and BidirectionalCell unrolled.
Twin cells are built under fresh NameManagers and the reference's weights
cross over by name; each case compares the outputs, the last states and
the gradients of sum(outputs * head) with respect to the input and every
parameter. The port's cells hybridized against their eager selves, and a
SequentialRNNCell of two LSTMCells against gluon.rnn.LSTM (the fused
layer's composite path on the CPU) with the same weights, which phase 16d
of chip_smoke.py repeats on the card against K4a.

Tolerances, float32: outputs and states within 1e-5, gradients within
1e-4 (matrix products summed in another order).
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


def _cell(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "rnn_tanh":
        return rnn.RNNCell(6, input_size=4)
    if kind == "rnn_relu":
        return rnn.RNNCell(6, activation="relu", input_size=4)
    if kind == "lstm":
        return rnn.LSTMCell(6, input_size=4)
    if kind == "gru":
        return rnn.GRUCell(6, input_size=4)
    if kind == "sequential":
        cell = rnn.SequentialRNNCell()
        with cell.name_scope():
            cell.add(rnn.LSTMCell(6, input_size=4))
            cell.add(rnn.DropoutCell(0.5))
            cell.add(rnn.GRUCell(5, input_size=6))
        return cell
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(4, input_size=4))
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.LSTMCell(6, input_size=4),
                               zoneout_outputs=0.3, zoneout_states=0.2)
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(3, input_size=4),
                                     rnn.GRUCell(5, input_size=4))
    raise ValueError(kind)


KINDS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "sequential", "residual",
         "zoneout", "bidirectional"]


def _twin(kind):
    with mx.name.NameManager():
        ref = _cell(mx, kind)
    with tmx.name.NameManager():
        port = _cell(tmx, kind)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    assert list(port.collect_params()) == list(ref.collect_params())
    gluon_params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                   ref.collect_params().items()})
    return ref, port


def _unrolled(pkg, cell, x, layout, merge, valid_length=None):
    """(outputs, last states, input gradient, {name: parameter gradient})
    of cell.unroll at inference under record, and the backward of
    sum(outputs * head) for a seeded head."""
    xin = pkg.nd.array(x)
    xin.attach_grad()
    vl = None if valid_length is None else pkg.nd.array(valid_length)
    with pkg.autograd.record(train_mode=False):
        outs, states = cell.unroll(5, xin, layout=layout,
                                   merge_outputs=merge, valid_length=vl)
        seq = outs if merge else pkg.nd.stack(*outs, axis=0)
        head = pkg.nd.array(_rand(*seq.shape, seed=11))
        loss = (seq * head).sum()
    loss.backward()
    return (seq.asnumpy(), [s.asnumpy() for s in states],
            xin.grad.asnumpy(),
            {n: p.grad().asnumpy().copy() for n, p in
             cell.collect_params().items() if p.grad_req != "null"})


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **_FWD)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **_FWD)
    np.testing.assert_allclose(got[2], want[2], **_GRAD)
    assert sorted(got[3]) == sorted(want[3])
    for n in want[3]:
        np.testing.assert_allclose(got[3][n], want[3][n], err_msg=n,
                                   **_GRAD)


@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", True),
                                          ("NTC", False)])
@pytest.mark.parametrize("kind", KINDS)
def test_unroll_matches_reference(kind, layout, merge):
    ref, port = _twin(kind)
    shape = (3, 5, 4) if layout == "NTC" else (5, 3, 4)
    x = _rand(*shape, seed=1)
    with _key_scope():
        want = _unrolled(mx, ref, x, layout, merge)
    got = _unrolled(tmx, port, x, layout, merge)
    _assert_same(got, want)


@pytest.mark.parametrize("kind", ["lstm", "gru", "bidirectional"])
def test_unroll_valid_length_matches_reference(kind):
    """Steps at or past each sequence's length are zero in the outputs
    (SequenceMask over the stacked steps). A bidirectional cell masks its
    reverse half in reversed time, as the reference does (its reverse
    cell unrolls the reversed list whatever the lengths)."""
    ref, port = _twin(kind)
    x = _rand(3, 5, 4, seed=2)
    lengths = np.array([5, 2, 3], np.float32)
    with _key_scope():
        want = _unrolled(mx, ref, x, "NTC", True, lengths)
    got = _unrolled(tmx, port, x, "NTC", True, lengths)
    _assert_same(got, want)
    fwd = got[0][..., :3] if kind == "bidirectional" else got[0]
    assert (fwd[1, 2:] == 0).all() and (fwd[2, 3:] == 0).all()


@pytest.mark.parametrize("kind,nstate", [("rnn_tanh", 1), ("lstm", 2),
                                         ("gru", 1)])
def test_cell_step_shapes_and_values(kind, nstate):
    """One step from begin_state (test_gluon.py's shapes), against the
    reference's step."""
    ref, port = _twin(kind)
    x = _rand(4, 4, seed=3)
    out = {}
    for pkg, cell in ((mx, ref), (tmx, port)):
        states = cell.begin_state(batch_size=4)
        assert len(states) == nstate and states[0].shape == (4, 6)
        o, new = cell(pkg.nd.array(x), states)
        assert o.shape == (4, 6) and len(new) == nstate
        out[pkg] = [o.asnumpy()] + [s.asnumpy() for s in new]
    for a, b in zip(out[tmx], out[mx]):
        np.testing.assert_allclose(a, b, **_FWD)


def test_unroll_list_inputs_and_begin_state():
    """A list of step inputs (layout TNC) and an explicit begin state, as
    test_gluon.py's unroll test; outputs a list of 5 steps."""
    ref, port = _twin("lstm")
    steps = [_rand(2, 4, seed=i) for i in range(5)]
    h0, c0 = _rand(2, 6, seed=7), _rand(2, 6, seed=8)
    res = {}
    for pkg, cell in ((mx, ref), (tmx, port)):
        outs, states = cell.unroll(
            5, [pkg.nd.array(s) for s in steps],
            begin_state=[pkg.nd.array(h0), pkg.nd.array(c0)],
            layout="TNC", merge_outputs=False)
        assert len(outs) == 5 and outs[0].shape == (2, 6)
        res[pkg] = [o.asnumpy() for o in outs] + [s.asnumpy()
                                                  for s in states]
    for a, b in zip(res[tmx], res[mx]):
        np.testing.assert_allclose(a, b, **_FWD)


@pytest.mark.parametrize("kind", KINDS)
def test_hybridized_cell_equals_eager(kind):
    with tmx.name.NameManager():
        cell = _cell(tmx, kind)
    cell.initialize(tmx.init.Xavier())
    x = _rand(3, 5, 4, seed=4)
    eager = _unrolled(tmx, cell, x, "NTC", True)
    cell.hybridize()
    hybrid = _unrolled(tmx, cell, x, "NTC", True)
    graphs = [c._cached_graph for c in [cell] + list(cell._children.values())
              if isinstance(c, tmx.gluon.HybridBlock)]
    assert any(g is not None for g in graphs)
    for a, b in zip(hybrid[:3], eager[:3]):
        if isinstance(a, list):
            for u, v in zip(a, b):
                np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for n in eager[3]:
        np.testing.assert_allclose(hybrid[3][n], eager[3][n], rtol=1e-6,
                                   atol=1e-6)


def _lstm_stack_and_layer(T, N, C, H, seed=0):
    """(SequentialRNNCell of two LSTMCells, gluon.rnn.LSTM of two layers)
    of the port with the same weights: the cells' i2h / h2h weights and
    biases are the layer's l0_ / l1_ parameters."""
    rnn = tmx.gluon.rnn
    with tmx.name.NameManager():
        stack = rnn.SequentialRNNCell()
        with stack.name_scope():
            stack.add(rnn.LSTMCell(H, input_size=C))
            stack.add(rnn.LSTMCell(H, input_size=H))
        layer = rnn.LSTM(H, num_layers=2, input_size=C, layout="TNC")
    stack.initialize(tmx.init.Xavier())
    layer.initialize(tmx.init.Xavier())
    lp = layer.collect_params()
    cells = list(stack._children.values())
    for i, cell in enumerate(cells):
        for part in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            value = _rand(*getattr(cell, part).shape, seed=seed + 10 * i
                          + len(part)) * 0.5
            getattr(cell, part).set_data(tmx.nd.array(value))
            lp[layer.prefix + "l%d_%s" % (i, part)].set_data(
                tmx.nd.array(value))
    return stack, layer


def test_lstm_cell_stack_equals_lstm_layer():
    T, N, C, H = 6, 3, 5, 7
    stack, layer = _lstm_stack_and_layer(T, N, C, H)
    x = _rand(T, N, C, seed=5)
    outs, states = stack.unroll(T, tmx.nd.array(x), layout="TNC",
                                merge_outputs=True)
    want = layer(tmx.nd.array(x), layer.begin_state(N))
    np.testing.assert_allclose(outs.asnumpy(), want[0].asnumpy(), **_FWD)
    h, c = want[1]
    np.testing.assert_allclose(states[0].asnumpy(), h.asnumpy()[0], **_FWD)
    np.testing.assert_allclose(states[1].asnumpy(), c.asnumpy()[0], **_FWD)
    np.testing.assert_allclose(states[2].asnumpy(), h.asnumpy()[1], **_FWD)
    np.testing.assert_allclose(states[3].asnumpy(), c.asnumpy()[1], **_FWD)


def test_modifier_and_bidirectional_rules():
    """A modified cell cannot begin states itself; a bidirectional cell
    cannot be stepped; dropout draws in training and is the identity at
    inference."""
    rnn = tmx.gluon.rnn
    base = rnn.RNNCell(4, input_size=4)
    res = rnn.ResidualCell(base)
    res.initialize()
    with pytest.raises(AssertionError):
        base.begin_state(batch_size=2)
    out, _ = res(tmx.nd.array(_rand(2, 4)), res.begin_state(batch_size=2))
    assert out.shape == (2, 4)
    bi = rnn.BidirectionalCell(rnn.GRUCell(4, input_size=3),
                               rnn.GRUCell(4, input_size=3))
    bi.initialize()
    with pytest.raises(NotImplementedError):
        bi(tmx.nd.array(_rand(2, 3)), bi.begin_state(batch_size=2))
    outs, _ = bi.unroll(5, [tmx.nd.array(_rand(2, 3, seed=i))
                            for i in range(5)], merge_outputs=False)
    assert outs[0].shape == (2, 8)
    drop = rnn.DropoutCell(0.5)
    x = tmx.nd.ones((50, 40))
    np.testing.assert_array_equal(drop(x, [])[0].asnumpy(), 1.0)
    with tmx.autograd.train_mode():
        kept = drop(x, [])[0].asnumpy()
    assert set(np.unique(kept)) == {0.0, 2.0}
    assert 0.4 < (kept == 0).mean() < 0.6
