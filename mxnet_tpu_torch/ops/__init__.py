"""Operators: those with hand-written CUDA kernels, each beside its plain
PyTorch version (``paged_attention``, ``flash_attention``,
``optimizer_ops``: the multi-tensor updates, which are also registered
ops, ``box_nms`` and ``int8_ops``: the int8 products of the quantized
ops and layers), and the registered ops of ``tensor``, ``nn``,
``contrib``, ``vision``, ``misc``, ``control_flow`` and
``quantized_ops`` (plain PyTorch and cuDNN, as the JAX package's are
plain XLA).  ``mx.nd`` imports the op modules, which registers them."""
