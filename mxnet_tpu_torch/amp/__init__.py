"""AMP, automatic mixed precision (the port's counterpart of
``mxnet_tpu/amp/__init__.py``; parity: python/mxnet/contrib/amp/amp.py).

The JAX package rewrites dtypes at its op registry's dispatch point.
The port mirrors AMP inside its ops instead: an op on one of the lists
(``lists.py``, copied from the JAX package) passes its inputs through
:func:`transform_inputs` before it computes, so one rule serves a
Gluon layer and the imperative op alike.  The ops that do so:
``Convolution``, ``FullyConnected`` (``nn.Dense``), BERT's tied head
(``dot``) and its attention (``_contrib_flash_attention``) run in the
target dtype; ``LayerNorm``, ``InstanceNorm`` and ``GroupNorm`` cast
their inputs to f32 and return f32; ``nn.Concurrent``'s ``concat``
takes the widest dtype; ``softmax_cross_entropy`` (``gluon.loss``)
takes its log-softmax in f32 always; ``BatchNorm`` is on no list and
runs in its input's dtype, with its parameters and running statistics
kept in f32 by ``nn.BatchNorm.cast``.  Torch's own type promotion gives
the widest dtype for a residual add.  The other list ops of
``ops/tensor.py`` (``mean``, ``exp``, the ``broadcast_*`` family, ...)
are not rewritten yet (``ROADMAP.md``).

The state is process-wide, as in the JAX package.
"""
from __future__ import annotations

import contextlib

import torch

from ..base import MXNetError
from . import lists
from .loss_scaler import LossScaler

_state = {
    "active": False,
    "target_dtype": None,
    "target_ops": frozenset(),
    "fp32_ops": frozenset(),
    "widest_ops": frozenset(),
}

_LOW = (torch.bfloat16, torch.float16)
_FLOATS = (torch.float32,) + _LOW
_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP process-wide (parity: amp.py:161).

    ``target_precision_ops`` and ``fp32_ops`` extend the default lists;
    ``conditional_fp32_ops`` is accepted for parity (treated as fp32)."""
    if target_dtype not in _TARGETS:
        raise MXNetError("AMP target_dtype must be bfloat16 or float16")
    target = set(lists.TARGET_DTYPE_OPS) | set(target_precision_ops or ())
    fp32 = set(lists.FP32_OPS) | set(fp32_ops or ())
    if conditional_fp32_ops:
        fp32 |= {op for op, _, _ in conditional_fp32_ops} \
            if isinstance(next(iter(conditional_fp32_ops)), tuple) \
            else set(conditional_fp32_ops)
    _state.update(
        active=True,
        target_dtype=_TARGETS[target_dtype],
        target_ops=frozenset(target),
        fp32_ops=frozenset(fp32),
        widest_ops=frozenset(lists.WIDEST_TYPE_CASTS),
    )


def turn_off():
    _state["active"] = False


def is_active():
    return _state["active"]


def _cast(d, dtype, kinds):
    if isinstance(d, torch.Tensor) and d.dtype in kinds and d.dtype != dtype:
        return d.to(dtype)
    return d


def transform_inputs(op_name, datas):
    """The dtypes ``op_name`` computes in under AMP: its floating inputs
    cast to the target dtype (target ops), to f32 (f32 ops) or to the
    widest among them (widest-type ops); as they are when AMP is off or
    the op is on no list.  ``None`` entries pass through."""
    datas = tuple(datas)
    if not _state["active"]:
        return datas
    if op_name in _state["target_ops"]:
        tgt = _state["target_dtype"]
        return tuple(_cast(d, tgt, _FLOATS) for d in datas)
    if op_name in _state["fp32_ops"]:
        return tuple(_cast(d, torch.float32, _LOW) for d in datas)
    if op_name in _state["widest_ops"]:
        fl = [d.dtype for d in datas
              if isinstance(d, torch.Tensor) and d.dtype in _FLOATS]
        if len(set(fl)) > 1:
            widest = torch.float32 if torch.float32 in fl else fl[0]
            return tuple(_cast(d, widest, _FLOATS) for d in datas)
    return datas


def convert_hybrid_block(net, target_dtype="bfloat16"):
    """Cast a Gluon block's parameters for AMP (parity:
    amp.convert_hybrid_block); enables AMP if it is not active yet."""
    if not _state["active"]:
        init(target_dtype)
    net.cast(target_dtype)
    return net


def init_trainer(trainer):
    """Attach a dynamic ``LossScaler`` to a Trainer (parity: amp.py:305):
    its ``step`` skips an update whose gradients overflowed, zeroing
    them (the JAX package's ``p.zero_grad()``), and the scale adapts."""
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    orig_step = trainer.step

    def step(batch_size, ignore_stale_grad=False):
        params = [p for p in trainer._params if p.requires_grad]
        overflow = scaler.has_overflow(params)
        if scaler.update_scale(overflow):
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.zero_()
            return
        orig_step(batch_size, ignore_stale_grad=ignore_stale_grad)

    trainer.step = step


def unscale(trainer):
    """Divide the current gradients by the loss scale (parity:
    amp.py:406)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.requires_grad and p.grad is not None:
                p.grad.mul_(inv)
    # the gradients are unscaled: undo the 1/loss_scale folded into step()
    if hasattr(trainer, "_amp_orig_scale"):
        trainer._scale = trainer._amp_orig_scale


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Scale the loss and fold 1/scale into the optimizer's rescale_grad
    (parity: amp.py:380)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
    if not hasattr(trainer, "_amp_orig_scale"):
        trainer._amp_orig_scale = trainer._scale
    # step() divides by batch_size on top of _scale, so folding
    # 1/loss_scale into _scale makes the update see unscaled gradients
    trainer._scale = trainer._amp_orig_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale
