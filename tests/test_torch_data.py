"""The port's ``gluon.data`` against the JAX package's, on the CPU:
``DataLoader`` over ``ArrayDataset`` with a seeded shuffle (every
``last_batch`` mode, 0 and 2 workers), the samplers, the ``Dataset``
combinators, the vision transforms, and ``MNIST``/``CIFAR10`` read from
tiny files written in their formats.

Both packages' random draws (shuffles, crops, flips, jitters) come
from numpy's global generator, so each side is run after the same
``np.random.seed``.  Tolerance: batches, orders, indices and uint8
images exact; float transforms rtol 1e-6 / atol 1e-5.
"""
import gzip
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data
from mxnet_tpu_torch.gluon.data.vision import transforms as T

CPU = tmx.cpu()
FLOAT = dict(rtol=1e-6, atol=1e-5)


def _np(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _batches(pkg, seed, **kw):
    x = np.arange(46, dtype=np.float32).reshape(23, 2)
    y = np.arange(23, dtype=np.int32) * 10
    loader = pkg.DataLoader(pkg.ArrayDataset(x, y), **kw)
    np.random.seed(seed)
    out = [[(_np(d), _np(l)) for d, l in loader] for _ in range(2)]
    return out, len(loader)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_jax(last_batch, workers):
    kw = dict(batch_size=5, shuffle=True, last_batch=last_batch,
              num_workers=workers)
    (jout, jlen), (tout, tlen) = _batches(jdata, 7, **kw), \
        _batches(data, 7, **kw)
    assert tlen == jlen
    assert len(tout) == len(jout)
    for tepoch, jepoch in zip(tout, jout):
        assert len(tepoch) == len(jepoch)
        for (td, tl), (jd, jl) in zip(tepoch, jepoch):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)


def test_dataloader_batches_are_host_ndarrays():
    x = np.ones((8, 3), np.float32)
    for pin in (False, True):
        loader = data.DataLoader(data.ArrayDataset(x), batch_size=4,
                                 pin_memory=pin)
        for b in loader:
            assert isinstance(b, tmx.nd.NDArray) and b.context == CPU
    with pytest.raises(ValueError):
        data.DataLoader(data.ArrayDataset(x))
    batch = data.DataLoader(data.SimpleDataset(
        [tmx.nd.array(r, ctx=CPU) for r in x]), batch_size=8)
    assert next(iter(batch)).shape == (8, 3)


def test_samplers_match_jax():
    for pkg in (jdata, data):
        assert list(pkg.SequentialSampler(5, start=2)) == [2, 3, 4, 5, 6]
    np.random.seed(3)
    j = list(jdata.RandomSampler(10))
    np.random.seed(3)
    assert list(data.RandomSampler(10)) == j
    for mode in ("keep", "discard", "rollover"):
        js = jdata.BatchSampler(jdata.SequentialSampler(7), 3, mode)
        ts = data.BatchSampler(data.SequentialSampler(7), 3, mode)
        assert [list(ts), list(ts)] == [list(js), list(js)]
        assert len(ts) == len(js)
    ds = list(range(10))
    assert list(data.FilterSampler(lambda s: s % 3 == 0, ds)) == \
        list(jdata.FilterSampler(lambda s: s % 3 == 0, ds))


def test_dataset_combinators_match_jax():
    rows = [(i, i * i) for i in range(12)]
    for name, op in (
            ("transform", lambda d: d.transform(lambda a, b: (b, a))),
            ("transform_first", lambda d: d.transform_first(lambda a: -a)),
            ("eager", lambda d: d.transform(lambda a, b: a + b, lazy=False)),
            ("filter", lambda d: d.filter(lambda s: s[0] % 2)),
            ("shard", lambda d: d.shard(5, 1)),
            ("take", lambda d: d.take(4))):
        j, t = op(jdata.SimpleDataset(rows)), op(data.SimpleDataset(rows))
        assert len(t) == len(j), name
        assert [t[i] for i in range(len(t))] == \
            [j[i] for i in range(len(j))], name
    with pytest.raises(MXNetError, match="S9"):
        data.RecordFileDataset("x.rec")


def _image(seed=0, h=10, w=8):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("name", ["ToTensor", "Normalize", "Resize",
                                  "Resize-keep", "CenterCrop", "Cast",
                                  "Compose"])
def test_deterministic_transforms_match_jax(name):
    def make(t):
        return {"ToTensor": lambda: t.ToTensor(),
                "Normalize": lambda: t.Normalize((0.5, 0.4, 0.3),
                                                 (0.2, 0.25, 0.3)),
                "Resize": lambda: t.Resize((5, 7)),
                "Resize-keep": lambda: t.Resize(6, keep_ratio=True),
                "CenterCrop": lambda: t.CenterCrop(6),
                "Cast": lambda: t.Cast("float16"),
                "Compose": lambda: t.Compose([t.Resize(6), t.ToTensor(),
                                              t.Normalize(0.5, 0.25)]),
                }[name]()
    img = _image()
    if name == "Normalize":
        img = img.transpose(2, 0, 1).astype(np.float32) / 255
    jout = make(jT)(jnd.array(img, dtype=str(img.dtype)))
    tout = make(T)(tmx.nd.array(img, ctx=CPU, dtype=str(img.dtype)))
    assert isinstance(tout, tmx.nd.NDArray) and tout.context == CPU
    assert tout.shape == jout.shape
    assert str(tout.dtype) == str(jout.dtype)
    np.testing.assert_allclose(_np(tout).astype(np.float32),
                               _np(jout).astype(np.float32), **FLOAT)


@pytest.mark.parametrize("name", ["RandomResizedCrop", "RandomCrop",
                                  "RandomFlipLeftRight",
                                  "RandomFlipTopBottom", "RandomBrightness",
                                  "RandomContrast", "RandomSaturation",
                                  "RandomHue", "RandomColorJitter",
                                  "RandomLighting"])
def test_random_transforms_match_jax_and_their_moments(name):
    def make(t):
        return {"RandomResizedCrop": lambda: t.RandomResizedCrop(5),
                "RandomCrop": lambda: t.RandomCrop(6, pad=2),
                "RandomFlipLeftRight": lambda: t.RandomFlipLeftRight(),
                "RandomFlipTopBottom": lambda: t.RandomFlipTopBottom(),
                "RandomBrightness": lambda: t.RandomBrightness(0.3),
                "RandomContrast": lambda: t.RandomContrast(0.3),
                "RandomSaturation": lambda: t.RandomSaturation(0.3),
                "RandomHue": lambda: t.RandomHue(0.2),
                "RandomColorJitter": lambda: t.RandomColorJitter(
                    0.2, 0.2, 0.2, 0.1),
                "RandomLighting": lambda: t.RandomLighting(0.1),
                }[name]()
    jt, tt = make(jT), make(T)
    outs = {"jax": [], "port": []}
    for tag, t, mod, kw in (("jax", jt, jnd, {}), ("port", tt, tmx.nd,
                                                  {"ctx": CPU})):
        np.random.seed(11)
        for i in range(12):
            img = _image(i)
            outs[tag].append(_np(t(mod.array(img, dtype="uint8", **kw)))
                             .astype(np.float32))
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, b, **FLOAT)
    # and the draws' moments over the run
    port, jax_ = np.stack(outs["port"]), np.stack(outs["jax"])
    np.testing.assert_allclose(port.mean(), jax_.mean(), rtol=1e-6)
    np.testing.assert_allclose(port.std(), jax_.std(), rtol=1e-6)


def _write_idx(path, arr, magic, gz):
    head = struct.pack(">II", magic, arr.shape[0])
    if arr.ndim == 3:
        head += struct.pack(">II", arr.shape[1], arr.shape[2])
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_from_idx_files_matches_jax(tmp_path, gz):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (6, 28, 28))
    labels = rs.randint(0, 10, 6)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", imgs, 2051, gz)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", labels, 2049, gz)
    j = mx.gluon.data.vision.MNIST(root=str(tmp_path), train=False)
    t = tmx.gluon.data.vision.FashionMNIST(root=str(tmp_path), train=False)
    assert len(t) == len(j) == 6
    for i in range(6):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.shape == (28, 28, 1) and ti.context == CPU
        np.testing.assert_array_equal(_np(ti), _np(ji))
        assert tl == jl
    with pytest.raises(MXNetError, match="train-images-idx3-ubyte"):
        tmx.gluon.data.vision.MNIST(root=str(tmp_path), train=True)


def test_cifar10_from_pickled_batches_matches_jax(tmp_path):
    rs = np.random.RandomState(1)
    batch = {"data": rs.randint(0, 256, (4, 3 * 32 * 32)).astype(np.uint8),
             "labels": list(rs.randint(0, 10, 4))}
    with open(tmp_path / "test_batch", "wb") as f:
        pickle.dump(batch, f)
    j = mx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=False)
    t = tmx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=False,
                                      transform=lambda x, y: (x, y + 1))
    assert len(t) == len(j) == 4
    for i in range(4):
        (ti, tl), (ji, jl) = t[i], j[i]
        np.testing.assert_array_equal(_np(ti), _np(ji))
        assert tl == jl + 1
    with pytest.raises(MXNetError, match="not found"):
        tmx.gluon.data.vision.CIFAR10(root=str(tmp_path), train=True)
    with pytest.raises(MXNetError, match="S9"):
        tmx.gluon.data.vision.ImageRecordDataset("x.rec")


def test_image_folder_dataset_reads_local_npy(tmp_path):
    for k, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        np.save(tmp_path / cls / "a.npy", _image(k, 4, 4))
    for pkg in (mx, tmx):
        ds = pkg.gluon.data.vision.ImageFolderDataset(str(tmp_path))
        assert ds.synsets == ["cat", "dog"] and len(ds) == 2
        img, label = ds[1]
        assert label == 1
        np.testing.assert_array_equal(_np(img), _image(1, 4, 4))
