"""Data iterators (the port's counterpart of ``mxnet_tpu/io/io.py``;
reference: ``python/mxnet/io/io.py`` and the native iterators of
``src/io/``: ``iter_mnist.cc``, ``iter_csv.cc``).

Host code, as in the JAX package: batches are assembled in numpy and
made NDArrays on the current context (the card unless a ``with
mx.cpu():`` scope says otherwise), one copy a batch.
``PrefetchingIter`` keeps the next batch ready on a background thread,
as the reference's ``PrefetcherIter`` does.  ``ImageRecordIter`` needs
``recordio``, ``image`` and the native decoder, which come with slice
S9 (ROADMAP.md): constructing one raises ``MXNetError``.
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..context import current_context
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray


class DataDesc(namedtuple('DataDesc', ['name', 'shape'])):
    """Data layout descriptor (parity: io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout='NCHW'):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (
            self.name, self.shape, self.dtype, self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find('N')

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (parity: io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base data iterator (parity: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Resize an iterator to a fixed epoch length (parity: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, 'default_bucket_key'):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffered prefetch over one or more iterators.

    Parity: io.py PrefetchingIter / native ``PrefetcherIter``
    (``src/io/iter_prefetcher.h:47``) — a producer thread keeps the next
    batch ready so host decode overlaps the card's step.  The producers
    run in the context of the thread that made the iterator, and an
    error in one is raised by the next ``next()`` (the JAX package's
    producer would die and leave ``next()`` waiting).
    """

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self._errors = [None] * self.n_iter
        # the producers make their batches on this thread's context (a
        # context scope is per thread)
        ctx = current_context()

        def prefetch_func(self, i):
            with ctx:
                while True:
                    self.data_taken[i].wait()
                    if not self.started:
                        break
                    try:
                        self.next_batch[i] = self.iters[i].next()
                    except StopIteration:
                        self.next_batch[i] = None
                    except Exception as e:  # noqa: BLE001 — re-raised
                        self.next_batch[i], self._errors[i] = None, e
                    self.data_taken[i].clear()
                    self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([
            [DataDesc(r[x.name], x.shape, x.dtype)
             if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
             for x in i.provide_data]
            for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([
            [DataDesc(r[x.name], x.shape, x.dtype)
             if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
             for x in i.provide_label]
            for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        for i, err in enumerate(self._errors):
            if err is not None:
                self._errors[i] = None
                raise err
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "Number of entry mismatches between iters"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iters"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad,
            self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize data into a list of (name, numpy array) (parity: io_utils)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {default_name + '_%d' % i: d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.ascontiguousarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity: io.py NDArrayIter).

    Supports shuffle, pad/discard/roll_over last-batch handling.
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.num_source = len(self.data)
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.data]

    @property
    def provide_label(self):
        return [
            DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                     v.dtype)
            for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        # epoch ended mid-tail: negative cursor in (-batch_size, 0) makes
        # _batchify concat the cached tail with the head of this epoch
        if self.last_batch_handle == 'roll_over' and \
                self.num_data - self.batch_size < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == 'discard':
                raise StopIteration
            # roll_over: cache the short tail for the next epoch and end
            # this one (the caller never sees an inconsistent-size batch)
            self._cache_data = data
            self._cache_label = label
            raise StopIteration
        return DataBatch(data=data, label=label,
                         pad=self.getpad(), index=None)

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        s = slice(start, end)
        return [nd.array(x[1][s]) for x in data_source]

    def _concat(self, first_data, second_data):
        if not first_data:
            return []
        return [
            nd.array(np.concatenate(
                (first_data[i].asnumpy(), second_data[i].asnumpy())))
            for i in range(len(first_data))]

    def _batchify(self, data_source):
        assert self.cursor < self.num_data
        if self.last_batch_handle == 'roll_over' and \
                -self.batch_size < self.cursor < 0:
            assert self._cache_data is not None or \
                self._cache_label is not None
            # getdata consumes _cache_data first, then getlabel finds it
            # cleared and consumes _cache_label — each cache is used once
            if self._cache_data is not None:
                cache, self._cache_data = self._cache_data, None
            else:
                cache, self._cache_label = self._cache_label, None
            second = self._getdata(
                data_source, end=self.cursor + self.batch_size)
            return self._concat(cache, second)
        if self.cursor + self.batch_size <= self.num_data:
            return self._getdata(
                data_source, self.cursor, self.cursor + self.batch_size)
        # tail: pad from head
        pad = self.batch_size - self.num_data + self.cursor
        first = self._getdata(data_source, self.cursor)
        if self.last_batch_handle == 'pad':
            second = self._getdata(data_source, end=pad)
            return self._concat(first, second)
        return first

    def getdata(self):
        return self._batchify(self.data)

    def getlabel(self):
        return self._batchify(self.label)

    def getpad(self):
        if self.last_batch_handle == 'pad' and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == 'roll_over' and \
                -self.batch_size < self.cursor < 0:
            return -self.cursor
        return 0

    def _shuffle_data(self):
        np.random.shuffle(self.idx)
        self.data = [(k, v[self.idx]) for k, v in self.data]
        self.label = [(k, v[self.idx]) for k, v in self.label]


class CSVIter(NDArrayIter):
    """CSV file iterator (parity: ``src/io/iter_csv.cc``).

    Host-side: loads the csv(s) with numpy then batches like NDArrayIter.
    """

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 shuffle=False, **kwargs):
        data = np.loadtxt(data_csv, delimiter=',', dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=',', dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        super().__init__(
            data, label, batch_size=batch_size, shuffle=shuffle,
            last_batch_handle='pad' if round_batch else 'discard',
            label_name='label')


def _read_idx_images(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, num, rows, cols = struct.unpack('>IIII', f.read(16))
        if magic != 2051:
            raise MXNetError("Bad magic %d in %s" % (magic, path))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(
            num, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, num = struct.unpack('>II', f.read(8))
        if magic != 2049:
            raise MXNetError("Bad magic %d in %s" % (magic, path))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


class MNISTIter(NDArrayIter):
    """MNIST idx-format iterator (parity: ``src/io/iter_mnist.cc``).

    Reads the standard idx(.gz) files from disk; no download (no egress).
    """

    def __init__(self, image='train-images-idx3-ubyte',
                 label='train-labels-idx1-ubyte', batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 **kwargs):
        if not os.path.exists(image):
            raise MXNetError("MNIST image file %s not found" % image)
        images = _read_idx_images(image).astype(np.float32) / 255.0
        labels = _read_idx_labels(label)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        super().__init__(images, labels, batch_size=batch_size,
                         shuffle=shuffle, label_name='softmax_label')


class ImageRecordIter(DataIter):
    """RecordIO image iterator (parity: ``iter_image_recordio_2.cc``): not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("mx.io.ImageRecordIter is not ported yet: it needs "
                         "recordio, image and the native decoder, which come "
                         "with slice S9 (ROADMAP.md)")
