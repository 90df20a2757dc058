"""DataLoader (the port's copy of ``mxnet_tpu/gluon/data/dataloader.py``;
parity: ``python/mxnet/gluon/data/dataloader.py``).

As in the JAX package, workers are the reference's *thread_pool* mode
(``ThreadPool`` path, ``dataloader.py:573``): samples are read and
batched in host threads, and ``num_workers`` keeps its meaning (0 =
synchronous), with a prefetch depth of 2 * num_workers.  Batches are
NDArrays on the host (``cpu()``), as the JAX package's are; the copy to
the card is the consumer's ``as_in_context``.  ``pin_memory=True`` pins
each batch's host tensor, so that copy can run asynchronously.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from collections import deque

import numpy as np

import torch

from ... import ndarray as nd
from ...context import cpu
from ...ndarray.ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler
from .dataset import Dataset


def default_batchify_fn(data):
    """Stack samples into a batch (parity: dataloader.py:default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, ctx=cpu(), dtype=data.dtype)


def default_mp_batchify_fn(data):
    """Parity alias — no shared-memory path is needed with threads."""
    return default_batchify_fn(data)


def _pinned(batch):
    """``batch`` with each NDArray's host tensor in pinned memory."""
    if isinstance(batch, NDArray):
        if batch.context.device_type == "cpu":
            batch._data = batch._data.pin_memory()
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pinned(b) for b in batch)
    return batch


class DataLoader:
    """Load batches from a Dataset (parity: dataloader.py DataLoader:441)."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=True,
                 timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory and torch.cuda.is_available()
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(
            0, int(prefetch) if prefetch is not None
            else 2 * self._num_workers)
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn
        self._pool = None
        if self._num_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=self._num_workers,
                thread_name_prefix='dataloader')

    def _make_batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pinned(batch) if self._pin_memory else batch

    def __iter__(self):
        if self._pool is None:
            for batch in self._batch_sampler:
                yield self._make_batch(batch)
            return
        # pipelined: keep up to prefetch batches in flight
        it = iter(self._batch_sampler)
        inflight = deque()
        try:
            for _ in range(max(1, self._prefetch)):
                try:
                    inflight.append(
                        self._pool.submit(self._make_batch, next(it)))
                except StopIteration:
                    break
            while inflight:
                yield inflight.popleft().result(timeout=self._timeout)
                try:
                    inflight.append(
                        self._pool.submit(self._make_batch, next(it)))
                except StopIteration:
                    pass
        finally:
            for fut in inflight:
                fut.cancel()

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        pool = getattr(self, "_pool", None)   # None if __init__ raised
        if pool is not None:
            pool.shutdown(wait=False)
