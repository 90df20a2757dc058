"""Flash attention, forward and backward (K1, K2 and K3 of the port).

``flash_attention(query, key, value, scale=None, causal=False)`` is the
contract of the JAX package's ``_contrib_flash_attention``: inputs are
``(B, H, T, D)`` or ``(BH, T, D)``, the output has the query's shape and
dtype, ``scale`` None or 0 means ``1/sqrt(D)``, and the causal mask is
aligned top-left (``col <= row`` from index 0, also when the query and
key lengths differ).  Arithmetic is f32; dq takes the query's dtype and
dk/dv the key's and value's.  A fully masked row gives output 0.

Gradients come from a ``torch.autograd.Function`` whose forward is K1
(output and a plain ``(BH, T)`` f32 logsumexp) and whose backward is the
two-pass flash backward: K2 sums dq over key tiles and K3 sums dk/dv over
query tiles, from the residuals ``(q, k, v, out, lse)`` and
``delta = rowsum(dO * O)`` (computed here in plain torch, as the JAX
package does).  No ``(T, T)`` buffer exists on the card in either
direction, and the gradients are deterministic.

Dispatch is by the device of the tensors, never by a fallback: CPU
tensors run the plain versions ``_flash_fwd_ref``/``_flash_bwd_ref``
inside the same Function; CUDA tensors launch the hand-written kernels
of ``csrc/flash_attention.cu`` (built by ``ops/_build.py``) or raise.
Unlike the JAX package, short sequences are not routed to plain
attention on the card, and a ragged T is masked inside the kernels
rather than sent to plain attention.  ``block_q``/``block_k`` are
accepted for the contract and ignored: the CUDA tiles are the kernels'
own.  bf16 inputs at head dims 64 and 128 whose buffers are 16-byte
aligned (lse and delta too, for the backward) run on bf16 tensor cores
with f32 accumulation (K1, K2 and K3 on ``wgmma`` fed by TMA); every
other case runs f32 products on the CUDA cores.  The kernels choose by
dtype, head dim and alignment; the caller has no switch.
``flash_attention.fwd_launches``, ``.dq_launches`` and ``.dkv_launches``
count kernel launches, those replayed in a captured CUDA graph included
(``graph_cache.count``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build
from .registry import register

_SOURCE = _build.source_path("flash_attention.cu")
MAX_HEAD_DIM = 256
MAX_BATCH_HEADS = 65535       # the kernels' grid y dimension
_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions ---------------------------------------------------------

def _scores(q, k, scale, causal):
    """f32 ``scale * q k^T`` with the top-left causal mask as -inf."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_kv = s.shape[-2], s.shape[-1]
        row = torch.arange(t_q, device=s.device)[:, None]
        col = torch.arange(t_kv, device=s.device)[None, :]
        s = s.masked_fill(col > row, float("-inf"))
    return s


def _attention_ref(q, k, v, scale, causal):
    """Plain attention on ``(BH, T, D)`` through torch's autograd (the
    counterpart of the JAX package's ``_attention_ref``)."""
    p = torch.softmax(_scores(q, k, scale, causal), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _flash_fwd_ref(q, k, v, scale, causal):
    """What K1 computes: ``(out, lse)``, out in q's dtype, lse f32
    ``(BH, Tq)``; a fully masked row gives out 0 and lse -inf."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(torch.isfinite(lse)[..., None],
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


def _flash_bwd_ref(q, k, v, do, lse, delta, scale, causal):
    """What K2 and K3 compute: ``(dq, dk, dv)`` from the normalized
    probabilities ``p = exp(s - lse)`` (0 where lse is -inf) and
    ``ds = p * (dO v^T - delta)``."""
    s = _scores(q, k, scale, causal)
    p = torch.where(torch.isfinite(lse)[..., None],
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dof = do.float()
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the kernels ------------------------------------------------------------

def library_path():
    """Where the built kernel library lives (``build/`` at the repo
    root, named by a hash of the source and flags)."""
    return _build.library_path(_SOURCE)


def build(verbose=False):
    """Compile ``csrc/flash_attention.cu`` with nvcc (when the library
    for this source is not built yet) and return its path."""
    return _build.build(_SOURCE, verbose=verbose)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.c_float, i, i, p]     # scale, causal, dtype, stream
    lib.mxtt_flash_fwd.argtypes = [p] * 5 + [i] * 4 + tail
    lib.mxtt_flash_bwd_dq.argtypes = [p] * 7 + [i] * 4 + tail
    lib.mxtt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 4 + tail
    for fn in (lib.mxtt_flash_fwd, lib.mxtt_flash_bwd_dq,
               lib.mxtt_flash_bwd_dkv):
        fn.restype = i
    lib.mxtt_flash_error_string.argtypes = [i]
    lib.mxtt_flash_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def _check_cuda(named):
    dev, dtype = named[0][1].device, named[0][1].dtype
    if dtype not in _CODES:
        raise MXNetError("flash_attention kernels take float32 or bfloat16, "
                         "got %s" % dtype)
    for name, t in named:
        if t.device != dev:
            raise MXNetError("flash_attention: %s is on %s, query on %s"
                             % (name, t.device, dev))
        if t.dtype != dtype:
            raise MXNetError("flash_attention: %s is %s, query %s"
                             % (name, t.dtype, dtype))
        if not t.is_contiguous():
            raise MXNetError("flash_attention: %s must be contiguous" % name)


def _run(name, counter, *args):
    """Call the C entry point ``name`` on the current stream, count the
    launch, and raise on a CUDA error."""
    lib = _load()
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _graph_cache.count(flash_attention, counter)
        err = getattr(lib, name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream)
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d (%s)"
                         % (name, err,
                            lib.mxtt_flash_error_string(err).decode()))


def _fwd_kernel(q, k, v, scale, causal):
    _check_cuda([("query", q), ("key", k), ("value", v)])
    bh, t_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    _run("mxtt_flash_fwd", "fwd_launches", q, k, v, out, lse, bh, t_q,
         k.shape[1], d, float(scale), int(causal), _CODES[q.dtype])
    return out, lse


def _bwd_kernels(q, k, v, do, lse, delta, scale, causal):
    _check_cuda([("query", q), ("key", k), ("value", v), ("grad", do)])
    bh, t_q, d = q.shape
    t_kv = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    common = (bh, t_q, t_kv, d, float(scale), int(causal), _CODES[q.dtype])
    _run("mxtt_flash_bwd_dq", "dq_launches", q, k, v, do, lse, delta, dq,
         *common)
    _run("mxtt_flash_bwd_dkv", "dkv_launches", q, k, v, do, lse, delta, dk,
         dv, *common)
    return dq, dk, dv


def _on(t, what):
    if t.device.type not in ("cuda", "cpu"):
        raise MXNetError("flash_attention runs on cuda or cpu tensors, got "
                         "%s for %s" % (t.device, what))
    return t.device.type == "cuda"


class _Flash(torch.autograd.Function):
    """K1 forward; K2 + K3 backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        if _on(q, "the forward"):
            out, lse = _fwd_kernel(q, k, v, scale, causal)
        else:
            out, lse = _flash_fwd_ref(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # delta_i = sum_d dO_id * O_id: O(T*D), the one piece of the
        # two-pass backward outside the kernels (as in the JAX package)
        delta = (do.float() * out.float()).sum(dim=-1)
        if _on(q, "the backward"):
            grads = _bwd_kernels(q, k, v, do, lse, delta, ctx.scale,
                                 ctx.causal)
        else:
            grads = _flash_bwd_ref(q, k, v, do, lse, delta, ctx.scale,
                                   ctx.causal)
        return grads + (None, None)


def flash_attention(query, key, value, scale=None, causal=False,
                    block_q=None, block_k=None):
    """Fused multi-head attention (see the module docstring).

    Inputs ``(B, H, T, D)`` or ``(BH, T, D)``; returns the query's shape
    and dtype.  Differentiable through the flash backward.  K and V are
    brought to the query's dtype first (autograd returns their gradients
    in their own dtypes).  ``block_q``/``block_k`` are accepted and
    ignored: the kernels' tiles are fixed.
    """
    del block_q, block_k
    squeeze = query.dim() == 3
    if squeeze:
        query, key, value = (x[:, None] if x.dim() == 3 else x
                             for x in (query, key, value))
    if query.dim() != 4 or key.dim() != 4 or value.dim() != 4:
        raise MXNetError("flash_attention wants (B, H, T, D) or (BH, T, D) "
                         "inputs, got %s / %s / %s"
                         % (tuple(query.shape), tuple(key.shape),
                            tuple(value.shape)))
    b, h, t_q, d = query.shape
    t_kv = key.shape[2]
    if tuple(key.shape) != (b, h, t_kv, d) or value.shape != key.shape:
        raise MXNetError("flash_attention: key %s and value %s do not match "
                         "query %s" % (tuple(key.shape), tuple(value.shape),
                                       tuple(query.shape)))
    if query.is_cuda and (d > MAX_HEAD_DIM or b * h > MAX_BATCH_HEADS):
        raise MXNetError("flash_attention kernels take head_dim <= %d and "
                         "B*H <= %d, got %d and %d" % (
                             MAX_HEAD_DIM, MAX_BATCH_HEADS, d, b * h))
    if scale is None or scale == 0:
        scale = 1.0 / (d ** 0.5)
    q3 = query.reshape(b * h, t_q, d).contiguous()
    k3 = key.to(query.dtype).reshape(b * h, t_kv, d).contiguous()
    v3 = value.to(query.dtype).reshape(b * h, t_kv, d).contiguous()
    out = _Flash.apply(q3, k3, v3, float(scale), bool(causal))
    out = out.reshape(b, h, t_q, d)
    return out[:, 0] if squeeze else out


flash_attention.fwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0


# the JAX package's registered op (``mxnet_tpu/ops/pallas_kernels.py:360``):
# ``nd.contrib.flash_attention`` on CUDA arrays launches K1 (K2 and K3 in
# its backward)
register("_contrib_flash_attention",
         inputs=("query", "key", "value"))(flash_attention)
