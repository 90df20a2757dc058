"""DLPack on the port, against the JAX package's, on the CPU.

``tests/test_dlpack.py``'s cases through both packages: numpy and torch
reading an array (capsule and protocol object), ``nd.from_dlpack`` of
JAX, numpy and torch objects and of a torch capsule, a round trip
through JAX, zero copy on the host, and writes through
``to_dlpack_for_write``.  Values are copied or aliased, so they are
compared exactly.  One deliberate difference: the port's exports alias
the array's tensor, so a write through the write capsule shows at once,
in the array and in an earlier read capsule; the JAX package writes a
host mirror that the array adopts at its next read, and its read
capsule is a snapshot (each package's behaviour is asserted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = (jmx, tmx)


@pytest.fixture(autouse=True)
def host():
    with tmx.cpu():
        yield


def test_np_from_dlpack_mx():
    for mx in PKGS:
        a = mx.nd.array(np.arange(6.0, dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(np.from_dlpack(a), a.asnumpy())


def test_torch_consumes_mx_capsule_and_object():
    for mx in PKGS:
        a = mx.nd.array(np.arange(4.0, dtype=np.float32))
        t1 = torch.utils.dlpack.from_dlpack(mx.nd.to_dlpack_for_read(a))
        t2 = torch.utils.dlpack.from_dlpack(a)
        np.testing.assert_array_equal(t1.numpy(), a.asnumpy())
        np.testing.assert_array_equal(t2.numpy(), a.asnumpy())


def test_from_dlpack_jax_and_numpy_objects():
    for mx in PKGS:
        a = mx.nd.from_dlpack(jnp.arange(5.0))
        assert isinstance(a, mx.nd.NDArray)
        np.testing.assert_array_equal(a.asnumpy(), np.arange(5.0))
        n = np.arange(4.0, dtype=np.float32)
        np.testing.assert_array_equal(mx.nd.from_dlpack(n).asnumpy(), n)
        assert mx.nd.from_dlpack(a) is a


def test_from_dlpack_torch_object_and_capsule():
    for mx in PKGS:
        t = torch.arange(6).float().reshape(2, 3)
        np.testing.assert_array_equal(mx.nd.from_dlpack(t).asnumpy(),
                                      t.numpy())
        cap = torch.utils.dlpack.to_dlpack(torch.arange(3).float())
        np.testing.assert_array_equal(mx.nd.from_dlpack(cap).asnumpy(),
                                      [0.0, 1.0, 2.0])


def test_round_trip_mx_jax_mx():
    for mx in PKGS:
        a = mx.nd.array(np.arange(8.0, dtype=np.float32))
        b = mx.nd.from_dlpack(jax.dlpack.from_dlpack(a))
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


def test_zero_copy_on_cpu():
    """The host shares the buffer: the consumer sees the same memory, and
    an import aliases the producer's."""
    a = jmx.nd.array(np.arange(4.0, dtype=np.float32))
    a.wait_to_read()
    t = torch.utils.dlpack.from_dlpack(a)
    assert t.data_ptr() == a.data().unsafe_buffer_pointer()
    b = tmx.nd.array(np.arange(4.0, dtype=np.float32))
    t = torch.utils.dlpack.from_dlpack(b)
    assert t.data_ptr() == b.data().data_ptr()
    src = torch.arange(3.0)
    assert tmx.nd.from_dlpack(src).data().data_ptr() == src.data_ptr()


def test_to_dlpack_for_write_visible():
    for mx in PKGS:
        a = mx.nd.array(np.zeros(4, np.float32))
        t = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
        t[:] = torch.tensor([1.0, 2.0, 3.0, 4.0])
        np.testing.assert_array_equal(a.asnumpy(), [1.0, 2.0, 3.0, 4.0])
        np.testing.assert_array_equal((a + 1).asnumpy(),
                                      [2.0, 3.0, 4.0, 5.0])


def test_write_seen_by_an_op_read():
    for mx in PKGS:
        a = mx.nd.array(np.ones(3, np.float32))
        t = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
        t *= 5.0
        assert float(mx.nd.sum(a).asscalar()) == 15.0


def test_read_capsule_then_write_capsule_same_array():
    """The port's read capsule aliases the array, so it sees the later
    write; the JAX package's is a snapshot."""
    got = {}
    for mx in PKGS:
        a = mx.nd.array(np.arange(3.0, dtype=np.float32))
        r = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_read())
        w = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
        w += 10.0
        np.testing.assert_array_equal(a.asnumpy(), [10.0, 11.0, 12.0])
        got[mx] = r.numpy().tolist()
    assert got[jmx] == [0.0, 1.0, 2.0]
    assert got[tmx] == [10.0, 11.0, 12.0]


def test_export_flushes_a_lazy_array_and_bumps_the_version():
    """An array a bulk segment defers flushes before it is exported, and
    the write export counts as a write (the version moves)."""
    with tmx.engine.bulk(8):
        a = tmx.nd.array(np.ones(3, np.float32)) * 3.0
        assert a._pending is not None
        v = a._var.version
        t = torch.utils.dlpack.from_dlpack(a.to_dlpack_for_write())
        assert a._pending is None and a._var.version == v + 1
    np.testing.assert_array_equal(t.numpy(), [3.0, 3.0, 3.0])
