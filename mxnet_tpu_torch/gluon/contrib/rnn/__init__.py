"""``gluon.contrib.rnn`` (counterpart of ``mxnet_tpu/gluon/contrib/rnn``):
``VariationalDropoutCell``, ``LSTMPCell`` and the convolutional RNN, LSTM
and GRU cells."""
from .rnn_cell import VariationalDropoutCell, LSTMPCell
from .conv_rnn_cell import (
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
