"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the data
samplers so far; ``nn`` and ``rnn`` wait for ROADMAP queue 1 #7 and #9."""
from . import data

__all__ = ["data"]
