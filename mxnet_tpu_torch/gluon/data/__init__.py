"""Gluon data API (parity: ``python/mxnet/gluon/data/``)."""
from .dataset import (  # noqa: F401
    Dataset, SimpleDataset, ArrayDataset, RecordFileDataset,
)
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler,
    FilterSampler,
)
from .dataloader import DataLoader  # noqa: F401
# the reference keeps its pre-1.5 loader importable under this name;
# the modern loader serves both roles here
DataLoaderV1 = DataLoader
from . import vision  # noqa: F401
