"""Data iterators and the device feed (counterpart of ``mxnet_tpu/io``)."""
from .io import (DataBatch, DataDesc, DataIter, ResizeIter, PrefetchingIter,
                 NDArrayIter, CSVIter, MNISTIter, ImageRecordIter,
                 LibSVMIter, DataLoaderIter)
from .device_feed import DeviceFeed, stage_batch

__all__ = ["DataBatch", "DataDesc", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "ImageRecordIter", "LibSVMIter", "DataLoaderIter", "DeviceFeed",
           "stage_batch"]
