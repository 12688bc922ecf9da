"""Symbolic RNN cells, the pre-Gluon mx.rnn API (port of
`mxnet_tpu/rnn/rnn_cell.py`; upstream `python/mxnet/rnn/rnn_cell.py`
BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell, SequentialRNNCell,
DropoutCell, ZoneoutCell, ResidualCell, BidirectionalCell, the Conv*
cells, and `rnn/rnn.py`'s checkpoint helpers). Cells compose Symbols;
`unroll` emits the graph the bucketing examples hand to BucketingModule.

`begin_state` with a batch size gives `sym.zeros` of the full shape;
without one (batch_size 0, upstream's default) a step cell's states are
aux Variables whose 0 dim shape inference fills from the bound data, and
`FusedRNNCell`'s are `sym.zeros((L, 0, H))` nodes whose 0 the executor
fills the same way and makes on its own device. `FusedRNNCell` is one
`RNN` op: with MXNET_FUSED_RNN=1 its lstm / rnn_relu / rnn_tanh layers
run the fused kernels (K4a-b) on the card.
"""
from __future__ import annotations

from .. import symbol as S


class RNNParams(object):
    """Container holding weight Variables shared by cells (parity:
    rnn_cell.py:78)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = S.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    @property
    def params(self):
        self._own_params = False
        return self._params

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def _gate_names(self):
        return ()

    @property
    def state_shape(self):
        """Shapes of the states (parity: rnn_cell.py state_shape)."""
        return [info["shape"] for info in self.state_info]

    def unpack_weights(self, args):
        """Split this cell's gate-concatenated i2h/h2h weight+bias into
        per-gate entries (parity: rnn_cell.py unpack_weights — the
        readable form of Module.get_params() for RNN cells)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            weight = args.pop("%s%s_weight" % (self._prefix, group))
            bias = args.pop("%s%s_bias" % (self._prefix, group))
            for j, gate in enumerate(self._gate_names):
                args["%s%s%s_weight" % (self._prefix, group, gate)] = \
                    weight[j * h:(j + 1) * h].copy()
                args["%s%s%s_bias" % (self._prefix, group, gate)] = \
                    bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Reverse of unpack_weights: concatenate per-gate entries back
        into the fused i2h/h2h parameters (parity: pack_weights)."""
        from .. import ndarray as _nd
        args = dict(args)
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            weight, bias = [], []
            for gate in self._gate_names:
                weight.append(args.pop(
                    "%s%s%s_weight" % (self._prefix, group, gate)))
                bias.append(args.pop(
                    "%s%s%s_bias" % (self._prefix, group, gate)))
            args["%s%s_weight" % (self._prefix, group)] = \
                _nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group)] = \
                _nd.concatenate(bias)
        return args

    def begin_state(self, func=None, batch_size=0, **kwargs):
        """Initial states.

        With a concrete ``batch_size``: `func` (zeros) of the full shape.
        With ``batch_size=0`` (the reference's symbolic default): aux
        Variables carrying a batch-deferred shape hint — shape inference
        resolves the 0 dim from the bound data batch, and the executor
        zero-fills unprovided aux states (parity: rnn_cell.py begin_state
        with symbol.zeros' 0-as-unknown shapes)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        if batch_size == 0:
            if func is not None:
                raise ValueError(
                    "begin_state(func=...) needs a concrete batch_size; "
                    "with batch_size=0 states are deferred zero aux vars")
            for info in self.state_info:
                self._init_counter += 1
                v = S.Variable("%sbegin_state_%d" % (self._prefix,
                                                     self._init_counter),
                               shape=tuple(info["shape"]),
                               attr={"__init__": "zeros"})
                v._outputs[0][0].is_aux = True
                states.append(v)
            return states
        func = func or S.zeros
        for info in self.state_info:
            self._init_counter += 1
            shape = tuple(batch_size if d == 0 else d
                          for d in info["shape"])
            states.append(func(shape=shape, **kwargs))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError()

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None,
               batch_size=0):
        """Unroll the cell over `length` steps (parity: rnn.py:26
        rnn_unroll / BaseRNNCell.unroll)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [S.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, S.Symbol):
            inputs = [S.squeeze(sl, axis=axis)
                      for sl in _split_time(inputs, length, axis)]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = _merge_time(outputs, axis)
        return outputs, states


def _split_time(inputs, length, axis):
    """Split [.., T, ..] into per-step symbols (keeps the T axis, size 1)."""
    split = S.SliceChannel(inputs, axis=axis, num_outputs=length)
    return [split[i] for i in range(length)]


def _merge_time(outputs, axis):
    """Stack per-step outputs back into one [.., T, ..] symbol."""
    return S.Concat(*[S.expand_dims(o, axis=axis) for o in outputs],
                    dim=axis)


class RNNCell(BaseRNNCell):
    """Vanilla RNN: h' = act(W_i x + W_h h + b) (parity: rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = S.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden,
                               name="%si2h" % name)
        h2h = S.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden,
                               name="%sh2h" % name)
        output = S.Activation(i2h + h2h, act_type=self._activation,
                              name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM (parity: rnn_cell.py:408; gate order i,f,c,o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init="zeros")
        self._hB = self.params.get("h2h_bias", init="zeros")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = S.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden * 4,
                               name="%si2h" % name)
        h2h = S.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden * 4,
                               name="%sh2h" % name)
        gates = i2h + h2h
        sliced = S.SliceChannel(gates, num_outputs=4,
                                name="%sslice" % name)
        in_gate = S.Activation(sliced[0], act_type="sigmoid")
        forget_gate = S.Activation(sliced[1] + self._forget_bias,
                                   act_type="sigmoid")
        in_transform = S.Activation(sliced[2], act_type="tanh")
        out_gate = S.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * S.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU (parity: rnn_cell.py:469; gates r,z,o)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev = states[0]
        i2h = S.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                               num_hidden=self._num_hidden * 3,
                               name="%si2h" % name)
        h2h = S.FullyConnected(prev, weight=self._hW, bias=self._hB,
                               num_hidden=self._num_hidden * 3,
                               name="%sh2h" % name)
        isl = S.SliceChannel(i2h, num_outputs=3)
        hsl = S.SliceChannel(h2h, num_outputs=3)
        i2h_r, i2h_z, i2h = isl[0], isl[1], isl[2]
        h2h_r, h2h_z, h2h = hsl[0], hsl[1], hsl[2]
        reset = S.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = S.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = S.Activation(i2h + reset * h2h, act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The whole multi-layer RNN as one `RNN` op (parity: rnn_cell.py:536,
    cuDNN's RNN there; here the op's composite scan, or K4a-b on the card
    with MXNET_FUSED_RNN=1). Without a batch size its begin states are
    `sym.zeros((L, 0, H))`, the 0 filled when the graph is bound."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, prefix=None, params=None,
                 get_next_state=False):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._get_next_state = get_next_state
        self._param = self.params.get("parameters")

    @property
    def state_info(self):
        dirs = 2 if self._bidirectional else 1
        b = self._num_layers * dirs
        if self._mode == "lstm":
            return [{"shape": (b, 0, self._num_hidden)},
                    {"shape": (b, 0, self._num_hidden)}]
        return [{"shape": (b, 0, self._num_hidden)}]

    def begin_state(self, func=None, batch_size=0, **kwargs):
        func = func or S.zeros
        states = []
        for info in self.state_info:
            shape = tuple(batch_size if d == 0 else d
                          for d in info["shape"])
            states.append(func(shape=shape, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None, batch_size=0):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        x = S.transpose(inputs, axes=(1, 0, 2)) if layout == "NTC" \
            else inputs
        rnn = S.RNN(x, self._param, *begin_state,
                    state_size=self._num_hidden,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._bidirectional,
                    state_outputs=self._get_next_state,
                    name="%srnn" % self._prefix)
        if self._get_next_state:
            out = rnn[0]
            states = [rnn[i] for i in range(1, len(self.state_info) + 1)]
        else:
            out, states = rnn, []  # parity: reference returns [] w/o request
        if layout == "NTC":
            out = S.transpose(out, axes=(1, 0, 2))
        if merge_outputs is False:
            steps = _split_time(out, length, layout.find("T"))
            out = [S.squeeze(s, axis=layout.find("T")) for s in steps]
        return out, states


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (parity: rnn_cell.py:748)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    def reset(self):
        super().reset()
        for c in getattr(self, "_cells", ()):  # child state must not leak
            c.reset()

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, func=None, batch_size=0, **kwargs):
        return sum((c.begin_state(func=func, batch_size=batch_size,
                                  **kwargs) for c in self._cells), [])

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout between stacked cells (parity: rnn_cell.py:827)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = S.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__(prefix="", params=None)
        self.base_cell = base_cell

    def reset(self):
        super().reset()
        if hasattr(self, "base_cell"):
            self.base_cell.reset()

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, batch_size=0, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func,
                                           batch_size=batch_size, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (parity: rnn_cell.py:909)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        if hasattr(self, "base_cell"):
            self.base_cell.reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0:
            prev = self._prev_output if self._prev_output is not None \
                else S.zeros_like(out)
            mask = S.Dropout(S.ones_like(out), p=self.zoneout_outputs)
            out = S.where(mask, out, prev)
        if self.zoneout_states > 0:
            masked = []
            for new, old in zip(next_states, states):
                m = S.Dropout(S.ones_like(new), p=self.zoneout_states)
                masked.append(S.where(m, new, old))
            next_states = masked
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    """output += input skip connection (parity: rnn_cell.py:957)."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over opposite time directions and concat
    (parity: rnn_cell.py:998). Only usable via unroll."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    def reset(self):
        super().reset()
        for c in (getattr(self, "_l_cell", None),
                  getattr(self, "_r_cell", None)):
            if c is not None:
                c.reset()

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, func=None, batch_size=0, **kwargs):
        return (self._l_cell.begin_state(func=func, batch_size=batch_size,
                                         **kwargs) +
                self._r_cell.begin_state(func=func, batch_size=batch_size,
                                         **kwargs))

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None, batch_size=0):
        self.reset()
        axis = layout.find("T")
        steps = _split_time(inputs, length, axis)
        steps = [S.squeeze(s, axis=axis) for s in steps]
        nl = len(self._l_cell.state_info)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        l_states = begin_state[:nl]
        r_states = begin_state[nl:]
        l_outs = []
        for x in steps:
            o, l_states = self._l_cell(x, l_states)
            l_outs.append(o)
        r_outs = []
        for x in reversed(steps):
            o, r_states = self._r_cell(x, r_states)
            r_outs.append(o)
        r_outs = list(reversed(r_outs))
        outs = [S.Concat(lo, ro, dim=1,
                         name="%st%d" % (self._output_prefix, i))
                for i, (lo, ro) in enumerate(zip(l_outs, r_outs))]
        if merge_outputs:
            outs = _merge_time(outs, axis)
        return outs, l_states + r_states


# -- checkpoint helpers (parity: rnn/rnn.py:32,62,97) -----------------------

def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    from ..model import save_checkpoint
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    from ..model import load_checkpoint
    return load_checkpoint(prefix, epoch)


def do_rnn_checkpoint(cells, prefix, period=1):
    from ..callback import do_checkpoint
    return do_checkpoint(prefix, period)


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", batch_size=0):
    """Deprecated functional unroll (parity: rnn/rnn.py:26)."""
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       input_prefix=input_prefix, layout=layout,
                       batch_size=batch_size)


# ---------------------------------------------------------------------------
# Convolutional recurrent cells (parity: the legacy symbolic
# rnn/rnn_cell.py BaseConvRNNCell/ConvRNNCell/ConvLSTMCell/ConvGRUCell —
# gluon-side equivalents live in gluon.contrib.rnn). States are feature
# maps; i2h/h2h are same-padded convolutions, so state spatial dims equal
# the input's.
# ---------------------------------------------------------------------------


class BaseConvRNNCell(BaseRNNCell):
    """Shared machinery: gate convolutions over NCHW feature maps.

    input_shape: (C, H, W) of each timestep's input. Odd kernels only
    (same padding keeps the recurrent state shape fixed, the invariant
    every conv-RNN formulation assumes)."""

    _num_gates = 1

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 i2h_kernel=(3, 3), activation="tanh", prefix="",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if any(k % 2 == 0 for k in tuple(h2h_kernel) + tuple(i2h_kernel)):
            raise ValueError("conv RNN cells need odd kernels (same "
                             "padding must preserve the state shape)")
        self._input_shape = tuple(input_shape)
        self._num_hidden = num_hidden
        self._h2h_kernel = tuple(h2h_kernel)
        self._i2h_kernel = tuple(i2h_kernel)
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias", init="zeros")
        self._hB = self.params.get("h2h_bias", init="zeros")

    @property
    def state_info(self):
        shape = (0, self._num_hidden) + self._input_shape[1:]
        return [{"shape": shape, "__layout__": "NCHW"}]

    def _conv_gates(self, inputs, state, name):
        nf = self._num_hidden * self._num_gates
        i2h = S.Convolution(
            inputs, weight=self._iW, bias=self._iB,
            kernel=self._i2h_kernel,
            pad=tuple(k // 2 for k in self._i2h_kernel),
            num_filter=nf, name="%si2h" % name)
        h2h = S.Convolution(
            state, weight=self._hW, bias=self._hB,
            kernel=self._h2h_kernel,
            pad=tuple(k // 2 for k in self._h2h_kernel),
            num_filter=nf, name="%sh2h" % name)
        return i2h, h2h

    def _act(self, x):
        return S.Activation(x, act_type=self._activation)


class ConvRNNCell(BaseConvRNNCell):
    """h' = act(conv(x) + conv(h)) (parity: rnn_cell.py ConvRNNCell)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 i2h_kernel=(3, 3), activation="tanh",
                 prefix="convrnn_", params=None):
        super().__init__(input_shape, num_hidden, h2h_kernel, i2h_kernel,
                         activation, prefix=prefix, params=params)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states[0], name)
        out = self._act(i2h + h2h)
        return out, [out]


class ConvLSTMCell(BaseConvRNNCell):
    """Shi et al. ConvLSTM (parity: rnn_cell.py ConvLSTMCell); state is
    (h, c), both feature maps."""

    _num_gates = 4

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 i2h_kernel=(3, 3), activation="tanh",
                 prefix="convlstm_", params=None, forget_bias=1.0):
        super().__init__(input_shape, num_hidden, h2h_kernel, i2h_kernel,
                         activation, prefix=prefix, params=params)
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        one = super().state_info[0]
        return [one, dict(one)]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states[0], name)
        sliced = S.SliceChannel(i2h + h2h, num_outputs=4,
                                name="%sslice" % name)
        in_gate = S.Activation(sliced[0], act_type="sigmoid")
        forget_gate = S.Activation(sliced[1] + self._forget_bias,
                                   act_type="sigmoid")
        in_transform = self._act(sliced[2])
        out_gate = S.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._act(next_c)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (parity: rnn_cell.py ConvGRUCell)."""

    _num_gates = 3

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 i2h_kernel=(3, 3), activation="tanh",
                 prefix="convgru_", params=None):
        super().__init__(input_shape, num_hidden, h2h_kernel, i2h_kernel,
                         activation, prefix=prefix, params=params)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_gates(inputs, states[0], name)
        isl = S.SliceChannel(i2h, num_outputs=3, name="%sislice" % name)
        hsl = S.SliceChannel(h2h, num_outputs=3, name="%shslice" % name)
        i_r, i_z, i_n = isl[0], isl[1], isl[2]
        h_r, h_z, h_n = hsl[0], hsl[1], hsl[2]
        reset = S.Activation(i_r + h_r, act_type="sigmoid")
        update = S.Activation(i_z + h_z, act_type="sigmoid")
        cand = self._act(i_n + reset * h_n)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]
