"""``gluon.rnn`` (counterpart of ``mxnet_tpu/gluon/rnn``): the recurrent
cells and the fused RNN, LSTM and GRU layers."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
