"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the data
samplers and the recurrent cells of ``rnn``; ``nn`` waits for ROADMAP
queue 1 #9."""
from . import data, rnn

__all__ = ["data", "rnn"]
