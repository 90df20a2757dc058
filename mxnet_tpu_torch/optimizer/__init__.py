"""Optimizers of the port (parity: mxnet_tpu.optimizer)."""
from .optimizer import (SGD, Adam, AdamW, Optimizer, create,  # noqa: F401
                        register)
