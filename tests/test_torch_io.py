"""The port's ``mx.io`` against the JAX package's, on the CPU.

``tests/test_io.py``'s iterator cases (``NDArrayIter`` with its
last-batch handling, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``)
and ``tests/test_sparse.py``'s six ``LibSVMIter`` cases run through both
packages on the same seeded data (the shuffles draw from numpy's global
generator, seeded alike before each package's run): every batch's data,
labels, ``pad`` and ``index`` must be equal, and each case's own
assertions hold in both (a value written to a libsvm file with ``%g``
against the value itself: within 1e-5).  Then ``MNISTIter`` on small
idx files, ``PrefetchingIter``'s producers on the port (the creator's
context, errors raised to the consumer), and the names that come with
slice S9 (``ImageRecordIter``) or that have no counterpart
(``MXDataIter``) raising.  The iterators are host code:
equality is exact.
"""
import gzip
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PKGS = (jmx, tmx)
# a value written with %g (6 significant digits) against the value
PRINTED = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def host():
    with tmx.cpu():
        yield


def _batches(it):
    """Each batch as numpy: (data, labels, pad, index)."""
    out = []
    for b in it:
        data = [d.tostype("default").asnumpy() if hasattr(d, "tostype")
                else d.asnumpy() for d in b.data]
        label = [lab.asnumpy() for lab in (b.label or [])]
        out.append((data, label, b.pad,
                    None if b.index is None else np.asarray(b.index)))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for (da, la, pa, ia), (db, lb, pb, ib) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)
        assert (ia is None) == (ib is None)
        if ia is not None:
            np.testing.assert_array_equal(ia, ib)


def _both(make, seed=0):
    got = []
    for mx in PKGS:
        np.random.seed(seed)
        got.append(_batches(make(mx)))
    _equal(got[1], got[0])
    return got[1]


# -- tests/test_io.py's iterator cases --------------------------------------


def test_ndarray_iter():
    data = np.ones([1000, 2, 2])
    labels = np.ones([1000, 1])
    for i in range(1000):
        data[i] = i / 100
        labels[i] = i / 100
    got = _both(lambda mx: mx.io.NDArrayIter(data, labels, 128, True,
                                             last_batch_handle="pad"))
    labelcount = [0] * 10
    for d, lab, _, _ in got:
        flat = lab[0].flatten()
        assert (d[0][:, 0, 0] == flat).all()
        for v in flat:
            labelcount[int(v)] += 1
    assert len(got) == 8
    assert sum(labelcount) == 8 * 128


def test_ndarray_iter_discard():
    data = np.arange(100).reshape(100, 1)
    got = _both(lambda mx: mx.io.NDArrayIter(data, None, 32, False,
                                             last_batch_handle="discard"))
    assert len(got) == 3
    assert all(d[0].shape == (32, 1) for d, _, _, _ in got)


@pytest.mark.parametrize("handle", ["pad", "roll_over"])
def test_ndarray_iter_reset(handle):
    data = np.arange(70).reshape(70, 1)

    def epochs(mx):
        it = mx.io.NDArrayIter(data, batch_size=20, last_batch_handle=handle)
        n1 = list(it)
        it.reset()
        return n1 + list(it)

    got = _both(epochs)
    assert len(got) == (8 if handle == "pad" else 7)


def test_resize_iter():
    data = np.arange(40).reshape(40, 1)
    got = _both(lambda mx: mx.io.ResizeIter(
        mx.io.NDArrayIter(data, batch_size=10), 7))
    assert len(got) == 7


def test_prefetching_iter():
    data = np.arange(80).reshape(80, 1)
    got = _both(lambda mx: mx.io.PrefetchingIter(
        mx.io.NDArrayIter(data, batch_size=20)))
    assert len(got) == 4
    np.testing.assert_array_equal(
        np.concatenate([d[0] for d, _, _, _ in got]).ravel(), np.arange(80))


def test_prefetching_iter_producers_keep_the_context_and_raise():
    """The port's producers make batches in the creating thread's context
    (here the host, from the fixture's scope) and raise a producer's
    error at the consumer's ``next()``; the JAX package's producer would
    die and leave ``next()`` waiting."""
    data = np.arange(8).reshape(8, 1)
    it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(data, batch_size=4))
    assert next(it).data[0].context == tmx.cpu()

    class Broken(tmx.io.NDArrayIter):
        def next(self):
            raise ValueError("a broken batch")

    it = tmx.io.PrefetchingIter(Broken(data, batch_size=4))
    with pytest.raises(ValueError, match="a broken batch"):
        next(it)


def test_csv_iter(tmp_path):
    path = str(tmp_path / "data.csv")
    arr = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    np.savetxt(path, arr, delimiter=",")
    got = _both(lambda mx: mx.io.CSVIter(data_csv=path, data_shape=(3,),
                                         batch_size=5))
    np.testing.assert_allclose(np.concatenate([d[0] for d, _, _, _ in got]),
                               arr, rtol=1e-5)


def test_data_desc_and_batch():
    for mx in PKGS:
        d = mx.io.DataDesc("data", (4, 3), layout="NC")
        assert d.name == "data" and d.shape == (4, 3) and d.layout == "NC"
        assert mx.io.DataDesc.get_batch_axis("TNC") == 1
        b = mx.io.DataBatch([mx.nd.zeros((2, 3))], pad=1)
        assert "data shapes: [(2, 3)]" in str(b)


# -- tests/test_sparse.py's LibSVMIter cases -------------------------------


def _write_libsvm(path, dense, labels):
    with open(path, "w") as f:
        for row, lab in zip(dense, labels):
            toks = ["%g" % lab]
            for j in np.nonzero(row)[0]:
                toks.append("%d:%g" % (j, row[j]))
            f.write(" ".join(toks) + "\n")


def test_libsvm_iter_round_trip(tmp_path):
    rs = np.random.RandomState(0)
    dense = (rs.randn(11, 6) * (rs.rand(11, 6) < 0.4)).astype(np.float32)
    labels = rs.randint(0, 2, 11).astype(np.float32)
    p = str(tmp_path / "train.libsvm")
    _write_libsvm(p, dense, labels)

    def run(mx):
        it = mx.io.LibSVMIter(data_libsvm=p, data_shape=(6,), batch_size=4)
        assert it.num_examples == 11
        batches = list(it)
        for b in batches:
            assert b.data[0].stype == "csr" and b.data[0].shape == (4, 6)
        it.reset()
        return batches + [next(it)]

    got = _both(run)
    assert len(got) == 4        # 3 batches, then the first after reset
    rows = np.concatenate([d[0] for d, _, _, _ in got[:3]])
    np.testing.assert_allclose(rows[:11], dense, **PRINTED)
    np.testing.assert_allclose(np.concatenate(
        [lab[0] for _, lab, _, _ in got[:3]])[:11], labels)
    np.testing.assert_allclose(got[2][0][0][3], dense[0], **PRINTED)
    np.testing.assert_allclose(got[3][0][0], dense[:4], **PRINTED)


def test_libsvm_iter_sharding(tmp_path):
    dense = np.diag(np.arange(1.0, 9.0)).astype(np.float32)
    labels = np.arange(8).astype(np.float32)
    p = str(tmp_path / "train.libsvm")
    _write_libsvm(p, dense, labels)
    seen = []
    for part in range(2):
        got = _both(lambda mx: mx.io.LibSVMIter(
            data_libsvm=p, data_shape=(8,), batch_size=2, num_parts=2,
            part_index=part, round_batch=False))
        for _, lab, _, _ in got:
            seen.extend(lab[0].tolist())
    assert sorted(seen) == labels.tolist()


def test_libsvm_parse_errors(tmp_path):
    p = str(tmp_path / "bad.libsvm")
    for text, match in (("1 9:1.0\n", "ZERO-based"), ("1 abc\n", "bad token"),
                        ("1 -1:7.0\n", "ZERO-based"),
                        ("1 2:abc\n", "bad token")):
        with open(p, "w") as f:
            f.write(text)
        for mx in PKGS:
            with pytest.raises(mx.base.MXNetError, match=match):
                mx.io.LibSVMIter(data_libsvm=p, data_shape=(6,),
                                 batch_size=1)


def test_libsvm_round_batch_exceeding_shard(tmp_path):
    dense = np.diag([1.0, 2.0, 3.0]).astype(np.float32)
    p = str(tmp_path / "tiny.libsvm")
    _write_libsvm(p, dense, np.arange(3.0))
    got = _both(lambda mx: [next(mx.io.LibSVMIter(
        data_libsvm=p, data_shape=(3,), batch_size=8))])
    np.testing.assert_allclose(got[0][0][0], dense[np.arange(8) % 3])
    assert got[0][2] == 5


def test_libsvm_no_round_batch_pads_to_full(tmp_path):
    dense = np.diag([1.0, 2.0, 3.0, 4.0, 5.0]).astype(np.float32)
    p = str(tmp_path / "five.libsvm")
    _write_libsvm(p, dense, np.arange(5.0))
    got = _both(lambda mx: mx.io.LibSVMIter(
        data_libsvm=p, data_shape=(5,), batch_size=4, round_batch=False))
    assert len(got) == 2
    assert got[-1][0][0].shape == (4, 5) and got[-1][2] == 3
    np.testing.assert_allclose(got[-1][0][0][0], dense[4])


def test_libsvm_label_file_and_read_libsvm(tmp_path):
    """Wide labels from a second libsvm file, and ``read_libsvm``'s CSR
    triplet, equal in both packages (the row slice of the port is one
    gather, the JAX package's a loop over rows)."""
    rs = np.random.RandomState(3)
    dense = (rs.randn(9, 7) * (rs.rand(9, 7) < 0.5)).astype(np.float32)
    lab = (rs.rand(9, 3) < 0.5).astype(np.float32)
    p, q = str(tmp_path / "d.libsvm"), str(tmp_path / "l.libsvm")
    _write_libsvm(p, dense, np.zeros(9))
    _write_libsvm(q, lab, np.zeros(9))
    got = _both(lambda mx: mx.io.LibSVMIter(
        data_libsvm=p, data_shape=(7,), label_libsvm=q, label_shape=(3,),
        batch_size=4))
    np.testing.assert_allclose(np.concatenate(
        [la[0] for _, la, _, _ in got])[:9], lab)
    want, have = (mx.io.read_libsvm(p, 7) for mx in PKGS)
    for a, b in zip(have, want):
        np.testing.assert_array_equal(a, b)


# -- the rest of io -----------------------------------------------------------


def _idx_files(tmp_path, n=10):
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_reads_idx_files(tmp_path, flat):
    ip, lp = _idx_files(tmp_path)
    got = _both(lambda mx: mx.io.MNISTIter(image=ip, label=lp, batch_size=4,
                                           shuffle=True, flat=flat), seed=5)
    assert got[0][0][0].shape == ((4, 784) if flat else (4, 1, 28, 28))
    for mx in PKGS:
        with pytest.raises(mx.base.MXNetError, match="not found"):
            mx.io.MNISTIter(image=str(tmp_path / "none"), label=lp)


def test_image_record_iter_and_mxdataiter_raise():
    with pytest.raises(MXNetError, match="S9"):
        tmx.io.ImageRecordIter(path_imgrec="x.rec", data_shape=(3, 8, 8),
                               batch_size=4)
    with pytest.raises(MXNetError, match="concrete iterator"):
        tmx.io.MXDataIter()
    assert os.path.basename(tmx.io.__file__) == "__init__.py"
