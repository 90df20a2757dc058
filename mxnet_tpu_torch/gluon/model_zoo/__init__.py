"""Model zoo of the port (parity: gluon.model_zoo): the Llama family,
BERT and the vision ResNets."""
from . import bert, llama, vision  # noqa: F401
from .vision import get_model  # noqa: F401
