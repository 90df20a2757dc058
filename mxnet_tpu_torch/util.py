"""General utilities (the port's counterpart of the JAX package's
``util.py``; reference: ``python/mxnet/util.py``).

The NumPy-semantics switches are re-exports of ``numpy_extension``,
which holds the per-thread flags; the device counts read
``torch.cuda``.
"""
from __future__ import annotations

import functools
import os

from .numpy_extension import (  # noqa: F401
    set_np, reset_np, set_np_shape, is_np_shape, is_np_array,
    np_shape, np_array, use_np,
)


def makedirs(d):
    """Create directories recursively if they don't exist
    (parity: util.py:42)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    """Number of GPU devices (parity: util.py:52), as ``mx.num_gpus``
    counts them."""
    from .context import num_gpus

    return num_gpus()


def get_accelerator_count():
    """Number of accelerators: the CUDA devices torch sees."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def use_np_shape(func):
    """Decorator applying np-shape semantics (parity: util.py:254)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)
    return wrapper


def use_np_array(func):
    """Decorator applying np-array semantics (parity: util.py:430)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_array(True):
            return func(*args, **kwargs)
    return wrapper


def set_module(module):
    """Decorator overriding ``__module__`` for cleaner docs
    (parity: util.py:335)."""
    def deco(fn):
        if module is not None:
            fn.__module__ = module
        return fn
    return deco


def wraps_safely(wrapped, assigned=functools.WRAPPER_ASSIGNMENTS):
    """functools.wraps tolerating missing attributes
    (parity: util.py:243)."""
    return functools.wraps(
        wrapped, assigned=(a for a in assigned if hasattr(wrapped, a)))
