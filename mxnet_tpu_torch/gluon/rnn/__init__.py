"""Gluon recurrent API (the port's counterpart of
``mxnet_tpu/gluon/rnn/``; parity: ``python/mxnet/gluon/rnn/__init__.py``).

Cells step by step (``rnn_cell.py``), fused layers over torch's fused
recurrence, cuDNN on the card (``rnn_layer.py``).
"""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
