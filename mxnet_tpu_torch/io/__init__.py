"""``mx.io`` — data iterators (the port's counterpart of
``mxnet_tpu/io/``; parity: ``python/mxnet/io/`` and ``src/io/``)."""
from .io import (  # noqa: F401
    DataDesc, DataBatch, DataIter, ResizeIter, PrefetchingIter,
    NDArrayIter, CSVIter, MNISTIter, ImageRecordIter,
)
from .libsvm import LibSVMIter, read_libsvm  # noqa: F401


def MXDataIter(*args, **kwargs):
    """The reference's wrapper over C iterator handles, which do not exist
    here: construct the iterator class itself."""
    from ..base import MXNetError

    raise MXNetError(
        "MXDataIter wraps the reference's C iterator handles, which do "
        "not exist in this runtime; construct the concrete iterator "
        "class instead (mx.io.MNISTIter / CSVIter / LibSVMIter / "
        "NDArrayIter)")
