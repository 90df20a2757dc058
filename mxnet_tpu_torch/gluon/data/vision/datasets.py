"""Vision datasets (the port's copy of
``mxnet_tpu/gluon/data/vision/datasets.py``; parity:
``python/mxnet/gluon/data/vision/datasets.py``).

Datasets read standard files already on disk (idx/idx.gz for the
MNIST family, pickled batches for CIFAR) and raise ``MXNetError`` naming
the missing file; nothing is downloaded.  Samples are as the
reference's: an HWC uint8 image (an NDArray on the host) and a scalar
label.  ``ImageRecordDataset`` needs RecordIO (slice S9) and raises.
"""
from __future__ import annotations

import os
import gzip
import pickle
import struct

import numpy as np

from ....base import MXNetError
from ....context import cpu
from .... import ndarray as nd
from ..dataset import Dataset, RecordFileDataset


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


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):  # pragma: no cover - abstract
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (parity: datasets.py MNIST:57)."""

    _train_files = ('train-images-idx3-ubyte', 'train-labels-idx1-ubyte')
    _test_files = ('t10k-images-idx3-ubyte', 't10k-labels-idx1-ubyte')

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'mnist'),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, name):
        for cand in (os.path.join(self._root, name),
                     os.path.join(self._root, name + '.gz')):
            if os.path.exists(cand):
                return cand
        raise MXNetError(
            "%s(.gz) not found under %s (no-egress environment: place the "
            "standard idx files there)" % (name, self._root))

    def _get_data(self):
        img_name, lbl_name = self._train_files if self._train \
            else self._test_files
        images = _read_idx_images(self._find(img_name))
        labels = _read_idx_labels(self._find(lbl_name))
        self._data = nd.array(images[..., None], ctx=cpu(), dtype='uint8')
        self._label = labels.astype(np.int32)


class FashionMNIST(MNIST):
    """FashionMNIST — same idx layout, different files (datasets.py:123)."""

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'fashion-mnist'),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local python-pickle batches (datasets.py CIFAR10:153)."""

    _train_names = ['data_batch_%d' % i for i in range(1, 6)]
    _test_names = ['test_batch']
    _coarse = False

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'cifar10'),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, 'rb') as f:
            batch = pickle.load(f, encoding='latin1')
        data = np.asarray(batch['data'], dtype=np.uint8)
        data = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = 'coarse_labels' if self._coarse else (
            'fine_labels' if 'fine_labels' in batch else 'labels')
        label = np.asarray(batch[key], dtype=np.int32)
        return data, label

    def _get_data(self):
        names = self._train_names if self._train else self._test_names
        found = []
        for name in names:
            for cand in (os.path.join(self._root, name),
                         os.path.join(self._root, 'cifar-10-batches-py',
                                      name),
                         os.path.join(self._root, 'cifar-100-python',
                                      name)):
                if os.path.exists(cand):
                    found.append(cand)
                    break
        if not found:
            raise MXNetError(
                "CIFAR batches %s not found under %s (no-egress "
                "environment)" % (names, self._root))
        data, label = zip(*[self._read_batch(name) for name in found])
        self._data = nd.array(np.concatenate(data), ctx=cpu(),
                              dtype='uint8')
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR100 (parity: datasets.py CIFAR100:208)."""

    _train_names = ['train']
    _test_names = ['test']

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'cifar100'),
                 fine_label=False, train=True, transform=None):
        self._coarse = not fine_label
        super().__init__(root, train, transform)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a RecordIO pack (datasets.py:254)."""

    def __init__(self, filename, flag=1, transform=None):
        raise MXNetError(
            "ImageRecordDataset(%r): RecordIO is not ported yet (recordio "
            "comes with slice S9, ROADMAP.md)" % (filename,))


class ImageFolderDataset(Dataset):
    """root/category/image.ext layout (datasets.py ImageFolderDataset:290).

    Image decode requires .npy payloads or PIL; standard image formats are
    listed for parity but decodable only when a codec is importable.
    """

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = ['.jpg', '.jpeg', '.png', '.npy']
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        path, label = self.items[idx]
        if path.endswith('.npy'):
            img = np.load(path)
        else:
            try:
                from PIL import Image
                img = np.asarray(Image.open(path))
            except ImportError:
                raise MXNetError(
                    "decoding %s needs PIL; use .npy images in this "
                    "environment" % path)
        img = nd.array(img, ctx=cpu(), dtype='uint8')
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
