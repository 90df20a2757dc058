"""Llama-family decoder-only language models (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/llama.py``).

The same blocks and attribute names as the JAX package, so that
``state_dict()`` keys equal its structural parameter names
(``embed.weight``, ``blocks.0.attn_norm.weight``,
``blocks.0.attn.q_proj.weight``, ..., ``norm.weight``,
``lm_head.weight``) and :func:`load_jax_params` carries weights across.

Attention runs through ``ops.flash_attention`` (K1 forward, K2 + K3
backward on the card).  Dtypes follow the JAX package under AMP with the
weights cast to bf16: projections run in the weights' dtype, RMSNorm and
RoPE compute in f32, and q, k and v enter the flash kernels in the
projections' dtype (``_contrib_flash_attention`` is on AMP's bf16 list),
although RoPE's f32 tables would promote q and k.  In f32 every step is
f32.  Sequence-parallel ring attention is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...context import resolve
from ...ops.flash_attention import flash_attention
from .. import nn
from ..block import HybridBlock


class RMSNorm(HybridBlock):
    """Root-mean-square norm (no mean subtraction), computed in f32 and
    returned in the input's dtype."""

    def __init__(self, units, eps=1e-6, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = eps
        self.weight = self.params.get("weight", shape=(units,), init="ones",
                                      device=resolve(device))

    def forward(self, x):
        x32 = x.float()
        ms = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(ms + self._eps) * self.weight.float()
        return out.to(x.dtype)


def _rope(x, base=10000.0):
    """Rotary position embedding on (B, H, T, D), rotate-half convention;
    f32 out, as the JAX package's f32 tables promote it."""
    b, h, t, d = x.shape
    half = d // 2
    inv = torch.arange(0, half, dtype=torch.float32, device=x.device) \
        * (-2.0 / d)
    inv_freq = torch.exp(inv * math.log(base))
    pos = torch.arange(0, t, dtype=torch.float32, device=x.device)
    freqs = pos.reshape(t, 1) * inv_freq.reshape(1, half)
    cos = torch.cos(freqs).reshape(1, 1, t, half)
    sin = torch.sin(freqs).reshape(1, 1, t, half)
    x = x.float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=3)


class LlamaAttention(HybridBlock):
    """Causal self-attention with RoPE and grouped-query KV heads."""

    def __init__(self, units, num_heads, num_kv_heads=None,
                 rope_base=10000.0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        num_kv_heads = num_kv_heads or num_heads
        if units % num_heads or num_heads % num_kv_heads:
            raise ValueError("units/num_heads/num_kv_heads mismatch")
        self._units = units
        self._heads = num_heads
        self._kv_heads = num_kv_heads
        self._base = rope_base
        d = units // num_heads

        def dense(out, prefix):
            return nn.Dense(out, flatten=False, use_bias=False,
                            in_units=units, prefix=prefix, device=device)

        with self.name_scope():
            self.q_proj = dense(units, "q_")
            self.k_proj = dense(num_kv_heads * d, "k_")
            self.v_proj = dense(num_kv_heads * d, "v_")
            self.o_proj = dense(units, "o_")

    def forward(self, x):
        b, t, _ = x.shape
        h, kv, d = self._heads, self._kv_heads, self._units // self._heads
        q = self.q_proj(x).reshape(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, t, kv, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, t, kv, d).transpose(1, 2)
        q = _rope(q, self._base).to(v.dtype)
        k = _rope(k, self._base).to(v.dtype)
        if kv != h:
            # GQA: each KV head serves h // kv consecutive query heads
            # (jnp.repeat semantics: repeat each head in place)
            k = k.repeat_interleave(h // kv, dim=1)
            v = v.repeat_interleave(h // kv, dim=1)
        out = flash_attention(q, k, v, scale=1.0 / math.sqrt(d), causal=True)
        out = out.transpose(1, 2).reshape(b, t, self._units)
        return self.o_proj(out)


class LlamaFFN(HybridBlock):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, units, hidden_size, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.gate = nn.Dense(hidden_size, flatten=False, use_bias=False,
                                 in_units=units, prefix="gate_",
                                 device=device)
            self.up = nn.Dense(hidden_size, flatten=False, use_bias=False,
                               in_units=units, prefix="up_", device=device)
            self.down = nn.Dense(units, flatten=False, use_bias=False,
                                 in_units=hidden_size, prefix="down_",
                                 device=device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(HybridBlock):
    """Pre-norm decoder block: x + attn(norm(x)); x + ffn(norm(x))."""

    def __init__(self, units, hidden_size, num_heads, num_kv_heads=None,
                 rope_base=10000.0, eps=1e-6, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attn_norm = RMSNorm(units, eps, prefix="attnorm_",
                                     device=device)
            self.attn = LlamaAttention(units, num_heads, num_kv_heads,
                                       rope_base, prefix="attn_",
                                       device=device)
            self.ffn_norm = RMSNorm(units, eps, prefix="ffnnorm_",
                                    device=device)
            self.ffn = LlamaFFN(units, hidden_size, prefix="ffn_",
                                device=device)

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class LlamaModel(HybridBlock):
    """Decoder-only LM.  forward(tokens (B, T)) -> logits (B, T, V).

    Parameters are made on ``device`` (default ``cuda:0``) in f32 and
    filled by ``initialize``; ``cast("bfloat16")`` then gives the AMP
    configuration."""

    def __init__(self, vocab_size, units=4096, hidden_size=11008,
                 num_layers=32, num_heads=32, num_kv_heads=None,
                 rope_base=10000.0, eps=1e-6, tie_embeddings=False,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        dev = resolve(device)
        self._units = units
        self._tie = tie_embeddings
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, units, prefix="embed_",
                                      device=dev)
            self.blocks = nn.HybridSequential(prefix="blocks_")
            for i in range(num_layers):
                self.blocks.add(LlamaBlock(units, hidden_size, num_heads,
                                           num_kv_heads, rope_base, eps,
                                           prefix="block%d_" % i,
                                           device=dev))
            self.norm = RMSNorm(units, eps, prefix="norm_", device=dev)
            if not tie_embeddings:
                self.lm_head = nn.Dense(vocab_size, flatten=False,
                                        use_bias=False, in_units=units,
                                        prefix="head_", device=dev)

    def forward(self, tokens):
        x = self.embed(tokens)
        x = self.blocks(x)
        x = self.norm(x)
        if self._tie:
            w = self.embed.weight
            return F.linear(x.to(w.dtype), w)
        return self.lm_head(x)


def llama3_8b(vocab_size=128256, **kwargs):
    """Llama-3-8B geometry: 32 layers, 4096 units, GQA 32/8 heads."""
    cfg = dict(units=4096, hidden_size=14336, num_layers=32, num_heads=32,
               num_kv_heads=8, rope_base=500000.0)
    cfg.update(kwargs)
    return LlamaModel(vocab_size, **cfg)


def llama2_7b(vocab_size=32000, **kwargs):
    """Llama-2-7B geometry: 32 layers, 4096 units, MHA."""
    cfg = dict(units=4096, hidden_size=11008, num_layers=32, num_heads=32)
    cfg.update(kwargs)
    return LlamaModel(vocab_size, **cfg)


def llama_small(vocab_size=512, **kwargs):
    """Tiny config for tests / dry-runs."""
    cfg = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
               num_kv_heads=2)
    cfg.update(kwargs)
    return LlamaModel(vocab_size, **cfg)


def load_jax_params(model, params):
    """Load ``{structural name: numpy array}`` (the JAX package's
    ``net._collect_params_with_prefix()`` names) into ``model``, in each
    parameter's dtype and on its device.  Strict: a missing, extra or
    mis-shaped name raises and names it."""
    own = {k: t for k, t in model._collect_params_with_prefix().items()
           if isinstance(t, torch.nn.Parameter)}
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, unexpected %s"
                         % (missing, extra))
    state = {}
    for name, p in own.items():
        a = np.asarray(params[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError("load_jax_params: %s has shape %s, the model "
                             "wants %s" % (name, a.shape, tuple(p.shape)))
        state[name] = torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=p.device, dtype=p.dtype)
    model.load_state_dict(state, strict=True)
    for p in model.parameters():
        p._initialized = True
    return model
