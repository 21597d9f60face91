"""Data iterators (counterpart of ``mxnet_tpu/io``): the in-memory
iterator ported so far."""
from .io import DataBatch, DataDesc, DataIter, NDArrayIter

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]
