"""Gluon recurrent cells (port of `mxnet_tpu/gluon/rnn/rnn_cell.py`):
RecurrentCell and HybridRecurrentCell (begin_state, unroll), RNNCell,
LSTMCell, GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
ZoneoutCell, ResidualCell and BidirectionalCell. This module is Gluon's;
the symbolic `mx.rnn` cells are `mxnet_tpu_torch/rnn/rnn_cell.py`.

Gate order i, f, g, o for the LSTM and r, z, n for the GRU, and the
parameter names (`lstm0_i2h_weight`, ...), are the reference's, so
weights carry across by name and into `gluon.rnn.LSTM`'s layout. A cell
steps through `HybridBlock.forward`, so a hybridized cell traces one step
into a cached graph (a Symbol input takes the symbol namespace), and
`unroll` calls that step `length` times. `unroll` takes the sequence as
one NDArray in `layout` ("NTC" or "TNC") or as a list of steps; with
`valid_length` the steps at or past each sequence's length are zeroed
through the SequenceMask op; the states it returns are the last step's.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd_mod


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(**{k: v for k, v in info.items()
                            if k != "__layout__"})
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout)
        if begin_state is None:
            # keyword, not positional: ModifierCell.begin_state's first
            # parameter is `func` (reference signature), not batch_size
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            from ... import ndarray as F
            stacked = F.stack(*outputs, axis=0)
            masked = F.SequenceMask(stacked, sequence_length=valid_length,
                                    use_sequence_length=True, value=0)
            outputs = [masked[i] for i in range(length)]
        outputs = _merge_outputs(outputs, axis if merge_outputs in (True, None)
                                 else None, merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _format_sequence(length, inputs, layout, merge=None):
    from ...ndarray import NDArray
    from ... import ndarray as F
    axis = layout.find("T")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[layout.find("N")]
        split = F.SliceChannel(inputs, num_outputs=length, axis=axis,
                               squeeze_axis=True)
        inputs = [split] if length == 1 else list(split)
    else:
        batch_size = inputs[0].shape[0]
    return inputs, axis, batch_size


def _merge_outputs(outputs, axis, merge):
    from ... import ndarray as F
    if merge is False:
        return outputs
    return F.stack(*outputs, axis=axis if axis is not None else 0)


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=_b(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=_b(h2h_bias_initializer),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _shape_probe(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])
        for p in (self.i2h_weight, self.h2h_weight, self.i2h_bias,
                  self.h2h_bias):
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_b(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_b(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _shape_probe(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])
        for p in (self.i2h_weight, self.h2h_weight, self.i2h_bias,
                  self.h2h_bias):
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        in_gate, forget_gate, in_trans, out_gate = F.SliceChannel(
            gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(in_gate)
        forget_gate = F.sigmoid(forget_gate)
        in_trans = F.tanh(in_trans)
        out_gate = F.sigmoid(out_gate)
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=_b(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=_b(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _shape_probe(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])
        for p in (self.i2h_weight, self.h2h_weight, self.i2h_bias,
                  self.h2h_bias):
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_r + h2h_r)
        update_gate = F.sigmoid(i2h_z + h2h_z)
        next_h_tmp = F.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), batch_size,
                                  **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args):
        raise NotImplementedError


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size, **kwargs):
    return sum([c.begin_state(batch_size=batch_size, **kwargs)
                for c in cells], [])


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs) \
            if func is not None else self.base_cell.begin_state(**kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(self.zoneout_outputs, next_output),
                         next_output, prev_output) \
            if self.zoneout_outputs > 0. else next_output
        new_states = [F.where(mask(self.zoneout_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if self.zoneout_states > 0. else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        rev_inputs = list(reversed(inputs))
        r_outputs, r_states = r_cell.unroll(
            length, inputs=rev_inputs,
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs = list(reversed(r_outputs))
        outputs = [F.Concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        outputs = _merge_outputs(outputs, axis, merge_outputs)
        states = l_states + r_states
        return outputs, states


def _b(spec):
    if spec is None or not isinstance(spec, str):
        return spec
    from ... import initializer
    return initializer.create(spec)
