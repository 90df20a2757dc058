"""Operators: those with hand-written CUDA kernels, each beside its plain
PyTorch version (``paged_attention``, ``flash_attention``,
``optimizer_ops``: the multi-tensor updates, which are also registered
ops), and the registered ops of ``tensor`` and ``nn`` (convolution,
pooling, BatchNorm, activations: plain PyTorch and cuDNN, as the JAX
package's are plain XLA)."""
