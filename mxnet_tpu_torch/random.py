"""``mx.random`` (parity: ``python/mxnet/random.py``; the port's
counterpart of the JAX package's ``random.py``).

The port's random ops, ``Dropout``, ``rrelu`` and the initializers draw
from torch's default generators: the host's and one per card, Philox
streams on the card whose offsets CUDA graphs advance at each replay.
``seed`` reseeds all of them.  They are per process, where the JAX
package keeps one threefry key per thread; ``ctx`` is accepted and, as
in the JAX package, changes nothing.
"""
from __future__ import annotations

import torch


def seed(seed_state, ctx="all"):
    """Reset every generator (the host's and each card's) to
    ``seed_state`` (parity: mx.random.seed)."""
    torch.manual_seed(int(seed_state))
