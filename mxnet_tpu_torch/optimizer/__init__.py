"""Optimizers of the port (parity: mxnet_tpu.optimizer)."""
from .optimizer import (  # noqa: F401
    Optimizer, SGD, NAG, SGLD, Adam, AdamW, AdaGrad, AdaDelta, RMSProp, Ftrl,
    Signum, FTML, DCASGD, Nadam, LAMB, LARS, Test, Updater, get_updater,
    create, register,
)
