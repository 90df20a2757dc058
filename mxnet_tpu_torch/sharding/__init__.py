"""Sharding of the port: so far the MXGC1 checkpoint reader and writer
(``checkpoint``); meshes and PartitionSpecs are slice S8."""
from .checkpoint import (  # noqa: F401
    is_global_checkpoint, load_global, load_index, save_global,
)
