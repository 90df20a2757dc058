"""Model zoo of the port (parity: gluon.model_zoo): the Llama family."""
from . import llama  # noqa: F401
