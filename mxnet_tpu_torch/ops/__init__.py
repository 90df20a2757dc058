"""Operators with hand-written CUDA kernels, each beside its plain
PyTorch version (``paged_attention``, ``flash_attention``)."""
