"""Gluon recurrent layers and cells (port of `mxnet_tpu/gluon/rnn/`): the
fused multi-layer RNN, LSTM and GRU layers and the cells of
`rnn_cell.py`."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
