"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn``,
reference python/mxnet/gluon/rnn/)."""
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ResidualCell,
                       BidirectionalCell, ModifierCell, ZoneoutCell)
from .rnn_layer import RNN, LSTM, GRU
