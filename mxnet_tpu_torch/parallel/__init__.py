"""Training steps of the port (parity: mxnet_tpu.parallel): the
single-device ``JitTrainStep``.  Meshes and sharding are slice S8."""
from .train_step import JitTrainStep  # noqa: F401
