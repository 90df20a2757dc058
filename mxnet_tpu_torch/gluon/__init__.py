"""Gluon for the port: blocks as ``torch.nn.Module``s, layers, losses,
the model zoo (Llama, the vision ResNets) and the single-device Trainer
(parity: mxnet_tpu.gluon)."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
