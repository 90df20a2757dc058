"""Dynamic loss scaler (parity: python/mxnet/contrib/amp/loss_scaler.py;
the JAX package's ``amp/loss_scaler.py``, copied, with the host read of a
gradient taught torch tensors).

Classic dynamic scaling: on overflow (non-finite grads) halve the scale
and skip the update; after ``scale_window`` clean steps double it.  With
bfloat16 (the TPU default) scaling is rarely needed — exponent range
matches float32 — but the API is kept for float16 parity.
"""
from __future__ import annotations

import numpy as np


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._min_scale = float(min_scale)
        self._unskipped = 0

    def has_overflow(self, params):
        """True if any gradient of ``params`` is non-finite."""
        for p in params:
            if getattr(p, "grad_req", "write") == "null":
                continue
            try:
                g = p.grad() if callable(getattr(p, "grad", None)) else p.grad
            except Exception:
                continue
            if g is None:
                continue
            # dynamic loss scaling must inspect grads on host
            if hasattr(g, "asnumpy"):
                a = g.asnumpy()
            elif hasattr(g, "detach"):         # a torch tensor, any dtype
                a = g.detach().float().cpu().numpy()
            else:
                a = np.asarray(g)
            if not np.isfinite(a.astype(np.float64)).all():
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
