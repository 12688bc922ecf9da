"""Port parity for mx.rnn's symbolic cells (mxnet_tpu_torch.rnn.rnn_cell)
against the JAX reference on the CPU.

Each cell is built in both packages under fresh NameManagers and
unrolled; the outputs and the final states are grouped into one Symbol,
bound through Module with input gradients, given the same numpy
parameters, and run forward (training mode) and backward with the same
head gradients. Layouts NTC and TNC, with and without a batch size
(FusedRNNCell: the port leaves its `sym.zeros` begin states' batch to the
bound data, the reference needs it given), with the next states
requested. Stochastic cells (Dropout, Zoneout) run in inference mode,
where they are deterministic. Also the helpers: unpack / pack_weights,
begin_state, the checkpoint helpers, `rnn_unroll`.

Tolerances: names and shapes exact; float32 outputs and gradients 1e-5.
"""
import os

import numpy as np
import pytest

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-5, atol=1e-5)
T, N, C, H = 4, 3, 5, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _lstm(pkg, prefix="lstm_"):
    return pkg.rnn.LSTMCell(H, prefix=prefix)


def _stack(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(H, prefix="l0_"))
    stack.add(pkg.rnn.DropoutCell(0.5, prefix="d0_"))
    stack.add(pkg.rnn.GRUCell(H, prefix="l1_"))
    return stack


#: name -> (cell factory, the cell has random parts, fused)
CELLS = {
    "rnn_tanh": (lambda pkg: pkg.rnn.RNNCell(H, prefix="rnn_"), False,
                 False),
    "rnn_relu": (lambda pkg: pkg.rnn.RNNCell(H, activation="relu",
                                             prefix="rnn_"), False, False),
    "lstm": (_lstm, False, False),
    "gru": (lambda pkg: pkg.rnn.GRUCell(H, prefix="gru_"), False, False),
    "sequential": (_stack, True, False),
    "residual": (lambda pkg: pkg.rnn.ResidualCell(
        pkg.rnn.GRUCell(C, prefix="res_")), False, False),
    "zoneout": (lambda pkg: pkg.rnn.ZoneoutCell(
        _lstm(pkg, "z_"), zoneout_outputs=0.3, zoneout_states=0.2), True,
        False),
    "bidirectional": (lambda pkg: pkg.rnn.BidirectionalCell(
        _lstm(pkg, "bl_"), pkg.rnn.GRUCell(H, prefix="br_")), False, False),
    "fused_lstm": (lambda pkg: pkg.rnn.FusedRNNCell(
        H, num_layers=2, mode="lstm", get_next_state=True), False, True),
    "fused_gru_bi": (lambda pkg: pkg.rnn.FusedRNNCell(
        H, num_layers=1, mode="gru", bidirectional=True,
        get_next_state=True), False, True),
    "fused_rnn_tanh": (lambda pkg: pkg.rnn.FusedRNNCell(
        H, num_layers=2, mode="rnn_tanh", get_next_state=True), False, True),
}


def _build(pkg, name, layout, batch_size, merge):
    make, _, fused = CELLS[name]
    with pkg.name.NameManager():
        cell = make(pkg)
        data = pkg.sym.Variable("data")
        if fused and pkg is mx:
            batch_size = N  # the reference's zeros need the batch
        outs, states = cell.unroll(T, inputs=data, layout=layout,
                                   merge_outputs=merge,
                                   batch_size=batch_size)
        outs = outs if isinstance(outs, list) else [outs]
        return pkg.sym.Group(outs + list(states))


def _data_shape(layout):
    return (N, T, C) if layout == "NTC" else (T, N, C)


def _run(pkg, sym, layout, train, params):
    """(outputs, {argument: gradient}) of sym bound through Module at the
    given parameters, head gradients from a seed."""
    mod = pkg.mod.Module(sym, data_names=["data"], label_names=None,
                         context=pkg.cpu())
    shape = _data_shape(layout)
    mod.bind(data_shapes=[("data", shape)], inputs_need_grad=True)
    mod.init_params(pkg.init.Zero())
    if params is None:
        arg, _ = mod.get_params()
        rng = np.random.RandomState(0)
        params = {n: (0.3 * rng.randn(*a.shape)).astype(np.float32)
                  for n, a in sorted(arg.items())}
    mod.set_params({n: pkg.nd.array(v) for n, v in params.items()}, {},
                   allow_missing=True)
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=train)
    outs = [o.asnumpy() for o in mod.get_outputs()]
    heads = [pkg.nd.array(rng.randn(*o.shape).astype(np.float32))
             for o in outs]
    grads = {}
    if train:
        mod.backward(heads)
        grads = {n: mod._exec.grad_dict[n].asnumpy()
                 for n in mod._exec.grad_dict}
        grads["data"] = mod.get_input_grads()[0].asnumpy()
    return outs, grads, params


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("batch_size", [0, N])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_through_module(name, batch_size, layout):
    _, random_parts, _ = CELLS[name]
    merge = name not in ("rnn_relu", "gru")  # a list of steps for those
    ref = _build(mx, name, layout, batch_size, merge)
    port = _build(tmx, name, layout, batch_size, merge)
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_outputs() == ref.list_outputs()
    if batch_size or CELLS[name][2]:
        assert port.list_auxiliary_states() == \
            ref.list_auxiliary_states() == []
    else:
        assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    train = not random_parts
    with _ref_scope():
        want, want_g, params = _run(mx, ref, layout, train, None)
    got, got_g, _ = _run(tmx, port, layout, train, params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **_TOL)
    assert sorted(got_g) == sorted(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n], want_g[n], err_msg=n, **_TOL)


@pytest.mark.parametrize("mode,bidirectional", [("lstm", False),
                                                ("gru", True),
                                                ("rnn_relu", False)])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_fused_cell_equals_sym_rnn(mode, bidirectional, fused, monkeypatch):
    """FusedRNNCell's graph is one RNN op: the same numbers as sym.RNN
    written by hand over the same parameters (the fused flag on reaches
    the kernels' plain versions here, for lstm and rnn_relu)."""
    monkeypatch.setenv("MXNET_FUSED_RNN", fused)
    cell = tmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                bidirectional=bidirectional, prefix="f_",
                                get_next_state=True)
    outs, states = cell.unroll(T, tmx.sym.Variable("data"), layout="TNC",
                               merge_outputs=True)
    dirs = 2 if bidirectional else 1
    zeros = [tmx.sym.zeros((2 * dirs, N, H))
             for _ in range(2 if mode == "lstm" else 1)]
    by_hand = tmx.sym.RNN(tmx.sym.Variable("data"),
                          tmx.sym.Variable("f_parameters"), *zeros,
                          state_size=H, num_layers=2, mode=mode,
                          bidirectional=bidirectional, state_outputs=True)
    rng = np.random.RandomState(5)
    size = tmx.ops.nn.rnn_param_size(2, C, H, bidirectional, mode)
    vals = {"data": tmx.nd.array(rng.randn(T, N, C).astype(np.float32)),
            "f_parameters": tmx.nd.array(
                (0.3 * rng.randn(size)).astype(np.float32))}
    got = tmx.sym.Group([outs] + states).eval(ctx=tmx.cpu(), **vals)
    want = by_hand.eval(ctx=tmx.cpu(), **vals)
    assert len(got) == len(want) == 1 + len(states)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_fused_flag_shape_inference_takes_meta_tensors(monkeypatch):
    """With MXNET_FUSED_RNN=1 an RNN node's shape inference runs the
    fused path on "meta" tensors: the plain versions take them (no kernel
    runs on the meta device)."""
    monkeypatch.setenv("MXNET_FUSED_RNN", "1")
    net = tmx.sym.RNN(tmx.sym.Variable("data"), state_size=8, num_layers=1,
                      mode="lstm", name="l")
    args, outs, _ = net.infer_shape(data=(5, 3, 4))
    assert outs == [(5, 3, 8)]
    assert args[1] == (tmx.ops.nn.rnn_param_size(1, 4, 8, False, "lstm"),)


@pytest.mark.parametrize("kind", ["ConvRNNCell", "ConvLSTMCell",
                                  "ConvGRUCell"])
def test_conv_cells(kind):
    shape = (2, 5, 5)
    syms = []
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            cell = getattr(pkg.rnn, kind)(shape, 3, prefix="c_")
            outs, states = cell.unroll(3, pkg.sym.Variable("data"),
                                       layout="TNC", merge_outputs=True,
                                       batch_size=2)
            syms.append(pkg.sym.Group([outs] + states))
    ref, port = syms
    assert port.list_arguments() == ref.list_arguments()
    mods = []
    rng = np.random.RandomState(3)
    x = rng.randn(3, 2, *shape).astype(np.float32)
    params = None
    for pkg, sym in ((mx, ref), (tmx, port)):
        with _ref_scope():
            mod = pkg.mod.Module(sym, data_names=["data"], label_names=None,
                                 context=pkg.cpu())
            mod.bind(data_shapes=[("data", x.shape)], for_training=False)
            mod.init_params(pkg.init.Zero())
            if params is None:
                arg, _ = mod.get_params()
                params = {n: (0.2 * rng.randn(*a.shape)).astype(np.float32)
                          for n, a in sorted(arg.items())}
            mod.set_params({n: pkg.nd.array(v) for n, v in params.items()},
                           {})
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x)]), is_train=False)
            mods.append([o.asnumpy() for o in mod.get_outputs()])
    for g, w in zip(mods[1], mods[0]):
        np.testing.assert_allclose(g, w, **_TOL)
    with pytest.raises(ValueError, match="odd kernels"):
        tmx.rnn.ConvRNNCell(shape, 3, h2h_kernel=(2, 2))


def test_unpack_pack_weights_and_state_info():
    ref, port = mx.rnn.LSTMCell(H, prefix="u_"), tmx.rnn.LSTMCell(
        H, prefix="u_")
    assert port.state_info == ref.state_info
    assert port.state_shape == ref.state_shape
    rng = np.random.RandomState(2)
    arrays = {"u_i2h_weight": rng.randn(4 * H, C), "u_i2h_bias":
              rng.randn(4 * H), "u_h2h_weight": rng.randn(4 * H, H),
              "u_h2h_bias": rng.randn(4 * H)}
    want = ref.unpack_weights({k: mx.nd.array(v.astype(np.float32))
                               for k, v in arrays.items()})
    got = port.unpack_weights({k: tmx.nd.array(v.astype(np.float32))
                               for k, v in arrays.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    packed = port.pack_weights(got)
    for k, v in arrays.items():
        np.testing.assert_array_equal(packed[k].asnumpy(),
                                      v.astype(np.float32))
    fused = tmx.rnn.FusedRNNCell(H, num_layers=3, bidirectional=True)
    assert fused.state_info == mx.rnn.FusedRNNCell(
        H, num_layers=3, bidirectional=True).state_info


def test_begin_state():
    cell = tmx.rnn.LSTMCell(H, prefix="b_")
    with pytest.raises(ValueError):
        cell.begin_state(func=tmx.sym.ones)
    states = cell.begin_state(func=tmx.sym.ones, batch_size=4)
    got = [s.eval(ctx=tmx.cpu())[0].asnumpy() for s in states]
    assert [g.shape for g in got] == [(4, H), (4, H)]
    assert all((g == 1).all() for g in got)
    aux = tmx.rnn.GRUCell(H, prefix="g_").begin_state()
    assert [s.list_auxiliary_states() for s in aux] == [["g_begin_state_0"]]
    modified = tmx.rnn.ZoneoutCell(tmx.rnn.LSTMCell(H, prefix="m_"))
    with pytest.raises(AssertionError):
        modified.base_cell.begin_state()
    assert len(modified.begin_state(batch_size=2)) == 2
    with pytest.raises(NotImplementedError):
        tmx.rnn.BidirectionalCell(cell, cell)(None, [])


def test_checkpoint_helpers_round_trip(tmp_path):
    cell = tmx.rnn.FusedRNNCell(H, num_layers=2, prefix="k_")
    outs, _ = cell.unroll(T, tmx.sym.Variable("data"), merge_outputs=True)
    sym = tmx.sym.Group([outs])
    rng = np.random.RandomState(6)
    arg = {"k_parameters": tmx.nd.array(rng.randn(
        tmx.ops.nn.rnn_param_size(2, C, H, False, "lstm"))
        .astype(np.float32))}
    prefix = str(tmp_path / "lm")
    tmx.rnn.save_rnn_checkpoint([cell], prefix, 3, sym, arg, {})
    sym2, arg2, aux2 = tmx.rnn.load_rnn_checkpoint([cell], prefix, 3)
    assert sym2.list_arguments() == sym.list_arguments()
    assert sym2.tojson() == sym.tojson()
    np.testing.assert_array_equal(arg2["k_parameters"].asnumpy(),
                                  arg["k_parameters"].asnumpy())
    # the reference reads the port's checkpoint
    rsym, rarg, _ = mx.rnn.load_rnn_checkpoint([], prefix, 3)
    assert rsym.list_arguments() == sym.list_arguments()
    np.testing.assert_array_equal(rarg["k_parameters"].asnumpy(),
                                  arg["k_parameters"].asnumpy())
    callback = tmx.rnn.do_rnn_checkpoint([cell], prefix, period=2)
    callback(0, sym, arg, {})
    assert not os.path.exists(prefix + "-0001.params")
    callback(1, sym, arg, {})
    assert os.path.exists(prefix + "-0002.params")


def test_rnn_unroll():
    outs = []
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            o, states = pkg.rnn.rnn_unroll(pkg.rnn.GRUCell(H, prefix="q_"),
                                           3, input_prefix="x_")
        outs.append((pkg.sym.Group(o + states).list_arguments(), len(o)))
    assert outs[0] == outs[1]
    assert outs[1][0][:3] == ["x_t0_data", "q_i2h_weight", "q_i2h_bias"]
