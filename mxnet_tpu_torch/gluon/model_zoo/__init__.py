"""Model zoo of the port (parity: gluon.model_zoo): the Llama family and
the vision ResNets."""
from . import llama, vision  # noqa: F401
