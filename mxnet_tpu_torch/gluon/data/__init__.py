"""Gluon's data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, the DataLoader and the vision datasets and transforms."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
