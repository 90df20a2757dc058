"""Datasets (parity: ``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

from ...base import MXNetError


class Dataset:
    """Abstract random-access dataset (parity: dataset.py Dataset)."""

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def filter(self, fn):
        """Return a dataset with only samples for which fn(sample) is True."""
        return _FilteredDataset(self, fn)

    def shard(self, num_shards, index):
        """Return the index-th of num_shards contiguous-strided shards —
        the per-host split used for data-parallel input pipelines."""
        return _ShardedDataset(self, num_shards, index)

    def take(self, count):
        return _TakenDataset(self, count)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Wrap any list-like (parity: dataset.py SimpleDataset)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _FilteredDataset(SimpleDataset):
    def __init__(self, dataset, fn):
        super().__init__([i for i in range(len(dataset))
                          if fn(dataset[i])])
        self._dataset = dataset

    def __getitem__(self, idx):
        return self._dataset[self._data[idx]]


class _ShardedDataset(Dataset):
    def __init__(self, dataset, num_shards, index):
        if not 0 <= index < num_shards:
            raise MXNetError("shard index %d out of range [0, %d)"
                             % (index, num_shards))
        self._dataset = dataset
        self._num = num_shards
        self._index = index
        length = len(dataset)
        self._start = (length // num_shards) * index + \
            min(index, length % num_shards)
        self._end = self._start + length // num_shards + \
            (1 if index < length % num_shards else 0)

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._dataset[self._start + idx]


class _TakenDataset(Dataset):
    def __init__(self, dataset, count):
        self._dataset = dataset
        self._count = min(count, len(dataset))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._dataset[idx]


class ArrayDataset(Dataset):
    """Zip several array-likes (parity: dataset.py ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has " \
                "length %d while array[%d] has %d." % (
                    self._length, i, len(data))
            if isinstance(data, Dataset):
                self._data.append(data)
            else:
                self._data.append(SimpleDataset(data))

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Each sample is one record of a RecordIO file (dataset.py:273)."""

    def __init__(self, filename):
        raise MXNetError(
            "RecordFileDataset(%r): RecordIO is not ported yet (recordio "
            "comes with slice S9, ROADMAP.md)" % (filename,))

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
