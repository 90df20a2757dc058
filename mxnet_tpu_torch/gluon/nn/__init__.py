"""Neural-network layers of the port (parity: gluon.nn)."""
from .basic_layers import (Dense, Embedding, HybridSequential,  # noqa: F401
                           Sequential)
