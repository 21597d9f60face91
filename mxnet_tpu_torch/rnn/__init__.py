"""The legacy ``mx.rnn`` API (counterpart of ``mxnet_tpu/rnn``): symbolic
cells, RNN checkpoints, and the bucketed sentence iterator."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn import (rnn_unroll, save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
from .io import encode_sentences, BucketSentenceIter
