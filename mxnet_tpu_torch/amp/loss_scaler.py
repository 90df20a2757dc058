"""Dynamic loss scaler (parity: python/mxnet/contrib/amp/loss_scaler.py;
the JAX package's ``amp/loss_scaler.py``, copied; its overflow check
reads one flag: O3 of ``ops/optimizer_ops.py`` checks every gradient of
a device in one pass, where the JAX package copies each to the host).

Classic dynamic scaling: on overflow (non-finite grads) halve the scale
and skip the update; after ``scale_window`` clean steps double it.  With
bfloat16 (the TPU default) scaling is rarely needed — exponent range
matches float32 — but the API is kept for float16 parity.
"""
from __future__ import annotations

import numpy as np
import torch


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._min_scale = float(min_scale)
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` is non-finite: one
        all-finite flag per device, read once (O3 on the card, where each
        gradient must be dense, as the port's parameters' gradients are;
        ``multi_sum_sq`` raises on a strided view there)."""
        from ..ops import optimizer_ops

        by_device = {}
        for p in params:
            if getattr(p, "grad_req", "write") == "null":
                continue
            try:
                g = p.grad() if callable(getattr(p, "grad", None)) else p.grad
            except Exception:
                continue
            if g is None:
                continue
            if hasattr(g, "_var"):             # an NDArray
                g = g.data()
            if not isinstance(g, torch.Tensor):
                g = torch.from_numpy(np.asarray(g, dtype=np.float32))
            g = g.detach()
            if not g.is_floating_point():
                continue
            if g.dtype not in (torch.float32, torch.bfloat16, torch.float16):
                g = g.float()
            by_device.setdefault(g.device, []).append(g)
        for grads in by_device.values():
            _, flag = optimizer_ops.multi_sum_sq(grads)
            if float(flag) == 0.0:
                return True
        return False

    def update_scale(self, overflow):
        """Adjust the scale; returns True if the step should be SKIPPED."""
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._unskipped >= self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
        return False
