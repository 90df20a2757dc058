"""Transformer encoder / BERT model family (the port's counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``).

The same blocks, attribute names and name scopes as the JAX package, so
that ``collect_params()`` gives its prefixed names
(``bertmodel0_enc_layers_cell0_attn_qkv_weight``) and ``state_dict()``
keys equal its structural parameter names
(``pos_embed``, ``mlm_bias``, ``word_embed.weight``, ``type_embed.weight``,
``ln.gamma``, ``encoder.layers.<i>.attn.qkv.weight``, ...,
``encoder.layers.<i>.ln2.beta``, ``pooler.weight``, ``pooler.bias``), in
the JAX package's order, and :func:`load_jax_params` carries weights
across.  Every layer is built with its input width (the JAX package
defers them to the first forward), so ``initialize`` fills every
parameter at once and a ``cast`` before the first forward casts them.

Self-attention is one fused ``qkv`` projection whose ``(3, B, H, T, D)``
split goes to ``ops.flash_attention`` (K1 forward, K2 + K3 backward on
the card), non-causal unless asked.  The FFN's GELU is the exact-erf
formula as the JAX package writes it, ``0.5*y*(1+erf(y/sqrt(2)))``, in
the FC output's dtype (the ``gelu`` op is the tanh approximation).
Cells are post-LN.  The MLM head is tied to ``word_embed.weight``:
``logits = seq . E^T + mlm_bias``.

Dtypes follow the JAX package under AMP with the weights cast to bf16:
the embeddings and their sum are bf16, every ``LayerNorm`` casts its
input to f32 and returns f32 (it is on AMP's f32 list), each ``Dense``
casts down to bf16, the residual adds take the wider f32, and the tied
head's product (``dot``, on the target list) gives bf16 logits.  So
``seq`` is f32, ``pooled`` and ``logits`` bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import amp as _amp
from ...context import resolve
from ...ops.flash_attention import flash_attention
from .. import nn
from ..block import HybridBlock
from .llama import load_jax_params  # noqa: F401  (the same strict loader)


class MultiHeadAttention(HybridBlock):
    """Self-attention with fused QKV and flash-attention scores."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise ValueError("units must divide num_heads")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units,
                                prefix="qkv_", device=device)
            self.proj = nn.Dense(units, flatten=False, in_units=units,
                                 prefix="proj_", device=device)
            self.drop = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        b, t, _ = x.shape
        h, d = self._heads, self._units // self._heads
        qkv = self.qkv(x).reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = _amp.transform_inputs("_contrib_flash_attention",
                                        (qkv[0], qkv[1], qkv[2]))
        out = flash_attention(q, k, v, scale=1.0 / math.sqrt(d),
                              causal=self._causal)
        out = self.proj(out.transpose(1, 2).reshape(b, t, self._units))
        if self.drop is not None:
            out = self.drop(out)
        return out


class PositionwiseFFN(HybridBlock):
    """Two-layer MLP with the exact GELU (BERT's FFN)."""

    def __init__(self, units, hidden_size, dropout=0.0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.fc1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                                prefix="fc1_", device=device)
            self.fc2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                                prefix="fc2_", device=device)
            self.drop = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.fc1(x)
        y = 0.5 * y * (1.0 + torch.erf(y / math.sqrt(2.0)))  # exact GELU
        y = self.fc2(y)
        if self.drop is not None:
            y = self.drop(y)
        return y


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout, causal,
                                           prefix="attn_", device=device)
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_",
                                    device=device)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       prefix="ffn_", device=device)
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_",
                                    device=device)

    def forward(self, x):
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    """``num_layers`` encoder cells under ``layers.<i>``."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.layers = nn.HybridSequential(prefix="layers_")
            for i in range(num_layers):
                self.layers.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout,
                    prefix="cell%d_" % i, device=device))

    def forward(self, x):
        return self.layers(x)


class BERTModel(HybridBlock):
    """BERT-style masked-LM encoder.

    ``forward(tokens, token_types=None)`` gives ``(seq (B, T, C), pooled
    (B, C)`` from the CLS position, ``logits (B, T, V))``; the MLM head
    ties the word embedding.  Parameters are made on ``device`` (default
    ``cuda:0``) in f32 and filled by ``initialize``: ``pos_embed`` by
    the initializer given, ``mlm_bias`` with zeros."""

    def __init__(self, vocab_size, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab=2, dropout=0.0, prefix=None, params=None,
                 device=None):
        super().__init__(prefix=prefix, params=params)
        dev = resolve(device)
        self._units = units
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units, prefix="word_",
                                           device=dev)
            self.type_embed = nn.Embedding(type_vocab, units,
                                           prefix="type_", device=dev)
            self.pos_embed = self.params.get(
                "pos_embed", shape=(max_length, units), device=dev)
            self.ln = nn.LayerNorm(in_channels=units, prefix="embln_",
                                   device=dev)
            self.drop = nn.Dropout(dropout) if dropout else None
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, prefix="enc_",
                                       device=dev)
            self.pooler = nn.Dense(units, flatten=False, activation="tanh",
                                   in_units=units, prefix="pooler_",
                                   device=dev)
            self.mlm_bias = self.params.get(
                "mlm_bias", shape=(vocab_size,), init="zeros", device=dev)

    def forward(self, tokens, token_types=None):
        b, t = tokens.shape
        emb = self.word_embed(tokens)
        if token_types is not None:
            emb = emb + self.type_embed(token_types)
        emb = emb + self.pos_embed[:t].unsqueeze(0)
        emb = self.ln(emb)
        if self.drop is not None:
            emb = self.drop(emb)
        seq = self.encoder(emb)
        pooled = self.pooler(seq[:, 0])
        # tied MLM head: logits = seq . E^T + b
        x, w = _amp.transform_inputs(
            "dot", (seq.reshape(b * t, self._units), self.word_embed.weight))
        dtype = torch.promote_types(x.dtype, w.dtype)
        logits = F.linear(x.to(dtype), w.to(dtype)).reshape(b, t, -1)
        return seq, pooled, logits + self.mlm_bias


def bert_base(vocab_size=30522, **kwargs):
    """BERT-base (110M params): 12 layers, 768 units, 12 heads."""
    cfg = dict(units=768, hidden_size=3072, num_layers=12, num_heads=12)
    cfg.update(kwargs)
    return BERTModel(vocab_size, **cfg)


def bert_small(vocab_size=1000, **kwargs):
    """Tiny config for tests / dry-runs."""
    cfg = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
               max_length=128)
    cfg.update(kwargs)
    return BERTModel(vocab_size, **cfg)
