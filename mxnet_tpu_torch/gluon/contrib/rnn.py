"""Contrib recurrent cells (port of `mxnet_tpu/gluon/contrib/rnn.py`):
VariationalDropoutCell, the convolutional cells Conv{1,2,3}D{RNN,LSTM,GRU}Cell
and LSTMPCell."""
from __future__ import annotations

from ..rnn.rnn_cell import (BidirectionalCell, HybridRecurrentCell,
                            ModifierCell, _b)


class VariationalDropoutCell(ModifierCell):
    """Dropout of the inputs, states and outputs with one mask each,
    drawn at the first step and reused across time (Gal & Ghahramani);
    `reset` (every unroll) draws new ones."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        assert not drop_states or not isinstance(base_cell, BidirectionalCell)
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, F, p, like):
        # Dropout of ones: a keep-and-scale mask in training, ones at
        # inference
        return F.Dropout(F.ones_like(like), p=p)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        if self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._mask(F, self.drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(F, self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        next_output, next_states = cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(F, self.drop_outputs,
                                               next_output)
            next_output = next_output * self._output_mask
        return next_output, next_states


# ---------------------------------------------------------------------------
# convolutional recurrent cells: i2h and h2h are convolutions over the
# spatial axes, through the layout-aware Convolution op
# ---------------------------------------------------------------------------


def _tup(v, dims):
    return (v,) * dims if isinstance(v, int) else tuple(v)


def _spatial_out(size, k, p, d):
    return tuple(x + 2 * pi - di * (ki - 1) for x, ki, pi, di
                 in zip(size, k, p, d))


class _ConvCellBase(HybridRecurrentCell):
    """Shared geometry/params/conv plumbing for the conv cell family."""

    _gate_names = ("",)

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        self._layout = conv_layout
        self._channels_last = conv_layout[-1] == "C"
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError("h2h_kernel must be odd so the recurrent conv "
                             "preserves the state's spatial size; got %s"
                             % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k
                              in zip(self._h2h_dilate, self._h2h_kernel))

        if self._channels_last:
            in_ch = input_shape[-1]
            spatial = input_shape[:-1]
        else:
            in_ch = input_shape[0]
            spatial = input_shape[1:]
        state_spatial = _spatial_out(spatial, self._i2h_kernel,
                                     self._i2h_pad, self._i2h_dilate)
        self._state_shape = (state_spatial + (hidden_channels,)
                             if self._channels_last
                             else (hidden_channels,) + state_spatial)
        gates = len(self._gate_names)
        out_ch = hidden_channels * gates
        if self._channels_last:
            i2h_shape = (out_ch,) + self._i2h_kernel + (in_ch,)
            h2h_shape = (out_ch,) + self._h2h_kernel + (hidden_channels,)
        else:
            i2h_shape = (out_ch, in_ch) + self._i2h_kernel
            h2h_shape = (out_ch, hidden_channels) + self._h2h_kernel
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=i2h_shape, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=h2h_shape, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(out_ch,),
            init=_b(i2h_bias_initializer or "zeros"),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(out_ch,),
            init=_b(h2h_bias_initializer or "zeros"),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._layout}
                for _ in range(len(self.state_info_names()))]

    def state_info_names(self):
        return ("h",)

    def _convs(self, F, inputs, state_h, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        gates = len(self._gate_names)
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, layout=self._layout,
                            num_filter=self._hidden_channels * gates)
        h2h = F.Convolution(state_h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate, layout=self._layout,
                            num_filter=self._hidden_channels * gates)
        return i2h, h2h

    def _split_gates(self, F, arr, n):
        axis = self._layout.find("C")
        return list(F.SliceChannel(arr, num_outputs=n, axis=axis))


class _ConvRNNCell(_ConvCellBase):
    _gate_names = ("",)

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = self._get_activation(F, i2h + h2h, self._activation)
        return out, [out]


class _ConvLSTMCell(_ConvCellBase):
    _gate_names = ("_i", "_f", "_c", "_o")

    def _alias(self):
        return "conv_lstm"

    def state_info_names(self):
        return ("h", "c")

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gi, gf, gc, go = self._split_gates(F, i2h + h2h, 4)
        i = F.sigmoid(gi)
        f = F.sigmoid(gf)
        o = F.sigmoid(go)
        c = f * states[1] + i * self._get_activation(F, gc, self._activation)
        h = o * self._get_activation(F, c, self._activation)
        return h, [h, c]


class _ConvGRUCell(_ConvCellBase):
    _gate_names = ("_r", "_z", "_o")

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        ir, iz, inew = self._split_gates(F, i2h, 3)
        hr, hz, hnew = self._split_gates(F, h2h, 3)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = self._get_activation(F, inew + r * hnew, self._activation)
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


def _make_conv_cell(base, dims, default_layout, alias):
    class Cell(base):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros",
                     conv_layout=default_layout, activation="tanh",
                     prefix=None, params=None):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                             i2h_weight_initializer, h2h_weight_initializer,
                             i2h_bias_initializer, h2h_bias_initializer,
                             dims, conv_layout, activation, prefix, params)
    Cell.__name__ = Cell.__qualname__ = alias
    return Cell


Conv1DRNNCell = _make_conv_cell(_ConvRNNCell, 1, "NCW", "Conv1DRNNCell")
Conv2DRNNCell = _make_conv_cell(_ConvRNNCell, 2, "NCHW", "Conv2DRNNCell")
Conv3DRNNCell = _make_conv_cell(_ConvRNNCell, 3, "NCDHW", "Conv3DRNNCell")
Conv1DLSTMCell = _make_conv_cell(_ConvLSTMCell, 1, "NCW", "Conv1DLSTMCell")
Conv2DLSTMCell = _make_conv_cell(_ConvLSTMCell, 2, "NCHW", "Conv2DLSTMCell")
Conv3DLSTMCell = _make_conv_cell(_ConvLSTMCell, 3, "NCDHW", "Conv3DLSTMCell")
Conv1DGRUCell = _make_conv_cell(_ConvGRUCell, 1, "NCW", "Conv1DGRUCell")
Conv2DGRUCell = _make_conv_cell(_ConvGRUCell, 2, "NCHW", "Conv2DGRUCell")
Conv3DGRUCell = _make_conv_cell(_ConvGRUCell, 3, "NCDHW", "Conv3DGRUCell")


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected recurrent state (arXiv:1402.1128). States:
    [r (batch, projection_size), c (batch, hidden_size)]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_b(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_b(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _shape_probe(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])
        for p in (self.i2h_weight, self.h2h_weight, self.h2r_weight,
                  self.i2h_bias, self.h2h_bias):
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=4 * self._hidden_size) + \
            F.FullyConnected(states[0], h2h_weight, h2h_bias,
                             num_hidden=4 * self._hidden_size)
        gi, gf, gc, go = list(F.SliceChannel(gates, num_outputs=4, axis=1))
        i = F.sigmoid(gi)
        f = F.sigmoid(gf)
        o = F.sigmoid(go)
        c = f * states[1] + i * F.tanh(gc)
        r = F.FullyConnected(o * F.tanh(c), h2r_weight, no_bias=True,
                             num_hidden=self._projection_size)
        return r, [r, c]
