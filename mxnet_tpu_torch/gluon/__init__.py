"""Gluon for the port: blocks as ``torch.nn.Module``s over ``Parameter``
handles, layers, losses, the model zoo (Llama, BERT, the vision
ResNets), the single-device Trainer, data loading and the utilities
(parity: mxnet_tpu.gluon)."""
from .parameter import (  # noqa: F401
    Constant, DeferredInitializationError, Parameter, ParameterDict,
)
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import contrib, data, loss, model_zoo, nn, utils  # noqa: F401
