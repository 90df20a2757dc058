"""Paged-attention prefill/decode/verify/chunk steps for the Llama
server, as PyTorch functions over the paged KV arena.

The port of ``mxnet_tpu/serve/model.py``.  The JAX package bakes the
weights into AOT-compiled XLA executables; here the same graphs are
plain functions on tensors, built once per geometry by
``build_step_fn`` / ``build_decode_fn`` / ``build_verify_fn`` /
``build_prefill_fn`` with the JAX package's signatures and argument
order, and run eagerly:

- ``prefill`` (one per sequence-length bucket): the whole prompt
  through full causal attention, every K/V row scattered into the paged
  arena, logits of the last real token returned;
- ``decode``: one token per lane, batched over ``max_batch`` — RoPE at
  the lane's position, scatter into the page the block table names, then
  attention over the lane's pages;
- ``verify`` (``spec_k > 0``) and ``chunk`` (``prefill_chunk > 0``):
  the same step at ``k1 = spec_k + 1`` / ``k1 = prefill_chunk`` tokens
  per lane; query ``j`` attends context ``<= positions[b] + j`` only.

Decode, verify and chunk attend through ``ops.paged_attention`` (the
Hopper kernel on CUDA, its plain version on the CPU) when the geometry's
``paged_kernel`` is ``"auto"`` or ``"1"``; ``"0"`` takes the gather +
grouped-einsum form.  The step functions update the arena tensors **in
place** (PyTorch has no buffer donation) and return them, so a caller
that adopts the returned tensors sees the same objects.

Numerics follow the JAX graphs: RMSNorm in f32 with ``rsqrt``, the RoPE
inverse-frequency table as ``exp(arange * (-2/D) * log(base))``,
rotate-half RoPE, GQA by grouping query heads over KV heads, and the
int8 slot-0 page-scale rule with round-half-to-even.  In float32 every
step mirrors the JAX graph operation for operation (tests/test_torch_*
hold them to 1e-4).  In bfloat16 the activations stay in bfloat16 and
attention outputs are cast back to it before the output projection,
where the JAX graphs let type promotion carry the residual stream in
float32.

Weights come from the JAX package's ``extract_weights(net)`` tuple
through :func:`convert_weights`, from a port bundle (one ``.npz`` with
the arrays plus the geometry, :func:`save_serving_bundle`), or from a
seed (:func:`init_weights`).
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, atomic_path
from ..context import resolve
from ..telemetry import memdump as _memdump

BUNDLE_KIND = "serving"
BUNDLE_FORMAT = "mxnet_tpu_torch.npz/1"

# geometry fields a serving bundle must carry; the load-time validator
# refuses a bundle missing any of them (fail at load, not on the first
# mismatched decode).  kv_dtype/spec_k are NOT
# in this list: older bundles lack them and must keep loading
# (defaulting to an fp32 arena with speculation off).
_GEOM_INT_FIELDS = ("num_layers", "num_heads", "num_kv_heads", "head_dim",
                    "units", "hidden_size", "vocab_size", "page_size",
                    "num_pages", "max_pages_per_seq", "max_batch")

# int8 paged-KV quantization constants.  A page's scale is fixed by its
# slot-0 row's absmax with this headroom (later rows clip past it);
# 2x keeps one extra bit of range for K/V magnitude drift within a page
# at the cost of one bit of precision.
_INT8_QMAX = 127.0
_INT8_SCALE_HEADROOM = 2.0
_INT8_MIN_SCALE = 1e-8  # an all-zero slot-0 row must not divide by zero


class KVGeometry:
    """Shape contract between exporter, arena, scheduler and executables.

    Everything the serving process must agree on with the bundle lives
    here: the paged-KV layout (``page_size`` tokens per page,
    ``num_pages`` total — page 0 is reserved as the null page inactive
    slots scribble on), the decode batch width ``max_batch`` the
    executable was compiled for, and the prefill bucket ladder.
    """

    def __init__(self, num_layers, num_heads, num_kv_heads, head_dim,
                 units, hidden_size, vocab_size, page_size, num_pages,
                 max_pages_per_seq, max_batch, prefill_buckets,
                 dtype="float32", rope_base=10000.0, eps=1e-6,
                 tie_embeddings=False, kv_dtype=None, spec_k=0,
                 paged_kernel=None, prefill_chunk=0):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.units = int(units)
        self.hidden_size = int(hidden_size)
        self.vocab_size = int(vocab_size)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.max_batch = int(max_batch)
        self.prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
        self.dtype = str(dtype)
        self.rope_base = float(rope_base)
        self.eps = float(eps)
        self.tie_embeddings = bool(tie_embeddings)
        # fields added later, with defaults: an old bundle dict that
        # carries neither loads as an fp32 arena with speculation off
        self.kv_dtype = str(kv_dtype) if kv_dtype else self.dtype
        self.spec_k = int(spec_k)
        # chunked-prefill width.  > 0 additionally compiles a
        # batched mid-sequence ``chunk`` executable (the step graph at
        # k1=prefill_chunk) so long / over-bucket prompts prefill in
        # ladder-sized chunks interleaved with decode steps, and cached
        # prefix splices resume mid-sequence.  0 = off; old bundle
        # dicts lack the field and load with it off.
        self.prefill_chunk = int(prefill_chunk)
        # which decode/verify/chunk attention the steps use — "auto"
        # and "1" the paged-attention op (the CUDA kernel on the card,
        # its plain version on the CPU), "0" the gather + grouped-einsum
        # form.  A bundle records the choice in its meta, a loaded
        # server inherits it.  Old bundle dicts lack the field and load
        # as "auto".
        if paged_kernel is None or paged_kernel == "":
            paged_kernel = "auto"
        if isinstance(paged_kernel, bool) or isinstance(paged_kernel, int):
            paged_kernel = str(int(paged_kernel))
        self.paged_kernel = str(paged_kernel).lower()
        self.validate()

    @property
    def max_context(self):
        """Tokens addressable per sequence (prompt + generated)."""
        return self.max_pages_per_seq * self.page_size

    def validate(self):
        if self.page_size <= 0 or self.num_pages <= 1:
            raise MXNetError(
                "KV geometry needs page_size>0 and num_pages>1 (page 0 is "
                "the reserved null page); got page_size=%d num_pages=%d"
                % (self.page_size, self.num_pages))
        if self.max_batch <= 0 or self.max_pages_per_seq <= 0:
            raise MXNetError("KV geometry needs max_batch>0 and "
                             "max_pages_per_seq>0")
        if not self.prefill_buckets:
            raise MXNetError("KV geometry needs at least one prefill bucket")
        if self.prefill_buckets[-1] > self.max_context:
            raise MXNetError(
                "largest prefill bucket (%d) exceeds max context %d "
                "(= max_pages_per_seq %d x page_size %d)"
                % (self.prefill_buckets[-1], self.max_context,
                   self.max_pages_per_seq, self.page_size))
        if self.num_heads % self.num_kv_heads:
            raise MXNetError("num_heads must be a multiple of num_kv_heads")
        if self.kv_dtype not in (self.dtype, "int8"):
            raise MXNetError(
                "kv_dtype must be the model dtype (%r) or 'int8', got %r"
                % (self.dtype, self.kv_dtype))
        if not 0 <= self.spec_k <= 64:
            raise MXNetError("spec_k must be in [0, 64] (draft tokens "
                             "verified per decode call), got %d"
                             % self.spec_k)
        if self.paged_kernel not in ("auto", "0", "1"):
            raise MXNetError(
                "paged_kernel must be 'auto', '0' or '1' (see "
                "MXNET_SERVE_PAGED_KERNEL in docs/env_vars.md), got %r"
                % self.paged_kernel)
        if self.prefill_chunk < 0 or self.prefill_chunk > self.max_context:
            raise MXNetError(
                "prefill_chunk must be in [0, max_context=%d] (0 "
                "disables chunked prefill), got %d"
                % (self.max_context, self.prefill_chunk))

    def to_dict(self):
        return {
            "num_layers": self.num_layers, "num_heads": self.num_heads,
            "num_kv_heads": self.num_kv_heads, "head_dim": self.head_dim,
            "units": self.units, "hidden_size": self.hidden_size,
            "vocab_size": self.vocab_size, "page_size": self.page_size,
            "num_pages": self.num_pages,
            "max_pages_per_seq": self.max_pages_per_seq,
            "max_batch": self.max_batch,
            "prefill_buckets": list(self.prefill_buckets),
            "dtype": self.dtype, "rope_base": self.rope_base,
            "eps": self.eps, "tie_embeddings": self.tie_embeddings,
            "kv_dtype": self.kv_dtype, "spec_k": self.spec_k,
            "paged_kernel": self.paged_kernel,
            "prefill_chunk": self.prefill_chunk,
        }

    @classmethod
    def from_dict(cls, d, origin="bundle"):
        missing = [f for f in _GEOM_INT_FIELDS if f not in d]
        if missing or "prefill_buckets" not in d:
            raise MXNetError(
                "%s: serving bundle geometry is missing %s — re-export "
                "with serve.export_serving_bundle"
                % (origin, ", ".join(missing) or "prefill_buckets"))
        return cls(**d)

    def kv_shape(self):
        """Arena buffer shape: (L, P, page, KV-heads, head-dim)."""
        return (self.num_layers, self.num_pages, self.page_size,
                self.num_kv_heads, self.head_dim)

    # the fields a replacement bundle must agree on for an in-place
    # hot-swap (``LlamaServer.reload``): everything the scheduler and
    # the queued requests already depend on — paging layout, batch
    # width, bucket ladder, vocabulary, arena dtype and verify width.
    # Model internals (layers, heads, weights) are free to change: the
    # arena is rebuilt from the new geometry and the executables are
    # self-contained.
    HOT_SWAP_FIELDS = ("page_size", "num_pages", "max_pages_per_seq",
                       "max_batch", "prefill_buckets", "vocab_size",
                       "kv_dtype", "spec_k", "prefill_chunk")

    def hot_swap_pins(self):
        """The geometry subset ``reload()`` pins (``check_geometry``
        dict) — a candidate bundle mismatching any of these would strand
        queued requests or tear live block tables."""
        d = self.to_dict()
        return {f: d[f] for f in self.HOT_SWAP_FIELDS}

    @property
    def quantized(self):
        """True when the arena stores int8 pages with per-page scales."""
        return self.kv_dtype == "int8"

    def scale_shape(self):
        """Per-page quantization scale shape: (L, pages); one float32
        scale per (layer, page) for each of K and V."""
        return (self.num_layers, self.num_pages)

    def describe(self):
        return ("layers=%d heads=%d/%d head_dim=%d pages=%dx%d "
                "max_batch=%d buckets=%s dtype=%s kv_dtype=%s spec_k=%d "
                "paged_kernel=%s prefill_chunk=%d"
                % (self.num_layers, self.num_heads, self.num_kv_heads,
                   self.head_dim, self.num_pages, self.page_size,
                   self.max_batch, list(self.prefill_buckets), self.dtype,
                   self.kv_dtype, self.spec_k, self.paged_kernel,
                   self.prefill_chunk))


def _env_int(name, default):
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


def default_buckets():
    """Prefill bucket ladder from MXNET_SERVE_BUCKETS (docs/env_vars.md)."""
    raw = os.environ.get("MXNET_SERVE_BUCKETS", "").strip()
    if not raw:
        return (32, 128, 512)
    try:
        return tuple(sorted({int(t) for t in raw.split(",") if t.strip()}))
    except ValueError:
        raise MXNetError("MXNET_SERVE_BUCKETS must be comma-separated ints, "
                         "got %r" % raw)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def torch_dtype(name):
    """The ``torch.dtype`` for a geometry dtype string."""
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise MXNetError("unsupported serving dtype %r (one of %s)"
                         % (name, sorted(_TORCH_DTYPES)))


def convert_weights(raw, dtype="float32", device=None):
    """``(embed, layers, norm, head)`` numpy arrays — the tuple the JAX
    package's ``extract_weights(net)`` returns, dense weights in (out,
    in) layout — as tensors of ``dtype`` on ``device`` (default
    ``cuda:0``).  ``head`` stays None for tied embeddings."""
    dev = resolve(device)
    dt = torch_dtype(dtype)

    def put(a):
        # np.array copies: extracted weights may be read-only views
        t = torch.from_numpy(np.array(a)).to(device=dev, dtype=dt)
        _memdump.tag(t, origin="param", label="serving_weight")
        return t

    embed, layers, norm, head = raw
    return (put(embed), [{k: put(v) for k, v in lw.items()} for lw in layers],
            put(norm), None if head is None else put(head))


def extract_weights(net):
    """The port's ``LlamaModel`` as the ``(embed, layers, norm, head)``
    numpy tuple that :func:`convert_weights` takes, as the JAX package's
    ``extract_weights`` gives it for its own model: dense weights in
    (out, in) layout, ``head`` None for tied embeddings, every array f32
    (numpy has no bf16).  A model trained in the port can then be
    served by the port."""
    def pull(p):
        return p.detach().float().cpu().numpy()

    layers = [{
        "attn_norm": pull(blk.attn_norm.weight),
        "q": pull(blk.attn.q_proj.weight),
        "k": pull(blk.attn.k_proj.weight),
        "v": pull(blk.attn.v_proj.weight),
        "o": pull(blk.attn.o_proj.weight),
        "ffn_norm": pull(blk.ffn_norm.weight),
        "gate": pull(blk.ffn.gate.weight),
        "up": pull(blk.ffn.up.weight),
        "down": pull(blk.ffn.down.weight),
    } for blk in net.blocks]
    head = None if net._tie else pull(net.lm_head.weight)
    return pull(net.embed.weight), layers, pull(net.norm.weight), head


_LAYER_KEYS = ("attn_norm", "q", "k", "v", "o", "ffn_norm", "gate", "up",
               "down")


def init_weights(geometry, seed=0, std=0.02, device=None):
    """Random Llama weights for ``geometry``, made on ``device`` from
    ``seed`` with a ``torch.Generator`` of that device: dense weights
    normal(0, ``std``) in the geometry dtype, norm gammas 1."""
    g = geometry
    dev = resolve(device)
    dt = torch_dtype(g.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    U, FF, V = g.units, g.hidden_size, g.vocab_size
    HD, KVD = g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim

    def normal(*shape):
        t = torch.empty(shape, dtype=dt, device=dev)
        t.normal_(0.0, std, generator=gen)
        _memdump.tag(t, origin="param", label="serving_weight")
        return t

    def ones(n):
        t = torch.ones(n, dtype=dt, device=dev)
        _memdump.tag(t, origin="param", label="serving_weight")
        return t

    embed = normal(V, U)
    layers = []
    for _ in range(g.num_layers):
        layers.append({"attn_norm": ones(U), "q": normal(HD, U),
                       "k": normal(KVD, U), "v": normal(KVD, U),
                       "o": normal(U, HD), "ffn_norm": ones(U),
                       "gate": normal(FF, U), "up": normal(FF, U),
                       "down": normal(U, FF)})
    head = None if g.tie_embeddings else normal(V, U)
    return embed, layers, ones(U), head


def _rmsnorm(x, gamma, eps):
    """f32-accumulated RMSNorm, as ops.nn.RMSNorm computes it."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


def _rope_tables(positions, head_dim, base):
    """cos/sin tables (…, half) for rotate-half RoPE at ``positions``
    (float32, any leading shape) — same inv-freq form as llama._rope."""
    half = head_dim // 2
    inv = torch.arange(0, half, dtype=torch.float32,
                       device=positions.device) * (-2.0 / head_dim)
    inv_freq = torch.exp(inv * math.log(base))
    freqs = positions[..., None] * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def _rotate(x, cos, sin):
    """Rotate-half on (…, D); cos/sin broadcast over the head axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _quantize(r32, scales):
    """int8 codes of f32 rows against per-row scales (round half to
    even, clipped to ±127)."""
    return torch.clamp(torch.round(r32 / scales[..., None, None]),
                       -_INT8_QMAX, _INT8_QMAX).to(torch.int8)


def _ffn(x, lw, eps):
    h2 = _rmsnorm(x, lw["ffn_norm"], eps)
    return x + F.linear(F.silu(F.linear(h2, lw["gate"]))
                        * F.linear(h2, lw["up"]), lw["down"])


def _logits(x, norm, embed, head, eps):
    xh = _rmsnorm(x, norm, eps)
    return F.linear(xh, embed if head is None else head).float()


def build_step_fn(weights, geometry, k1):
    """``k1`` tokens per lane through the paged arena in one call.

    The shared body of ``decode`` (``k1=1``), ``verify``
    (``k1=spec_k+1``) and ``chunk`` (``k1=prefill_chunk``).  Signature
    (all positional, tensors on the arena's device):

    - float: ``(kv_k, kv_v, tokens (B, k1), positions (B,),
      block_table (B, maxp)) -> (kv_k, kv_v, logits (B, k1, V) f32)``
    - int8: ``(kv_k, kv_v, k_scale (L, P) f32, v_scale (L, P) f32,
      tokens, positions, block_table) -> (kv_k, kv_v, k_scale, v_scale,
      logits)``

    The arena tensors are updated in place and returned.  Lane ``b``'s
    token ``j`` sits at position ``positions[b] + j`` and attends context
    ``<= positions[b] + j`` only, so the per-position logits equal what
    ``k1`` sequential single-token decodes would produce.  Inactive lanes
    point their block-table row at the null page 0 with position 0.

    Int8 append: the row landing on a page's slot 0 fixes the page scale
    (own absmax x headroom / 127); rows further into a page quantize
    against the page's current scale — the scale of its slot-0 write,
    in this call or an earlier one.  Nothing stored is requantized, so
    arena bytes after token t are independent of call grouping.
    """
    from ..ops.paged_attention import paged_attention as _paged_attn

    embed, layers, norm, head = weights
    g = geometry
    H, KV, D, S = g.num_heads, g.num_kv_heads, g.head_dim, g.page_size
    grp = H // KV
    scale = 1.0 / math.sqrt(D)
    maxp = g.max_pages_per_seq
    ctx = maxp * S
    int8 = g.quantized
    # "auto" and "1" attend through the paged-attention op (kernel on
    # CUDA, plain version on CPU); "0" gathers the context and attends
    # with grouped einsums, filling masked scores with -1e30
    kernel = g.paged_kernel in ("auto", "1")

    def append(kv, sc, li, pid, slot, rows, jidx):
        """Scatter ``rows`` (B, k1, KV, D) at (li, pid, slot); quantize
        against per-page scales when the arena is int8."""
        if not int8:
            kv[li, pid, slot] = rows.to(kv.dtype)
            return
        r32 = rows.float()
        amax = r32.abs().amax(dim=(2, 3))                    # (B, k1)
        # in-call page starts: token j's page began at call offset
        # j - slot[j]; negative means the page's slot 0 was written by
        # an earlier call and its stored scale rules
        start = jidx[None, :] - slot                         # (B, k1)
        first = torch.gather(amax, 1, start.clamp(0, k1 - 1))
        news = torch.where(start >= 0,
                           first * (_INT8_SCALE_HEADROOM / _INT8_QMAX),
                           sc[li, pid])
        news = torch.clamp_min(news, _INT8_MIN_SCALE)
        # rows of one page all write the page's resolved scale — equal
        # values, so duplicate scatter order cannot matter
        kv[li, pid, slot] = _quantize(r32, news)
        sc[li, pid] = news

    def gather(kv, sc, li, block_table, b, dt):
        """This lane's pages as (B, C, KV, D) in the model dtype."""
        pages = kv[li][block_table]              # (B, maxp, S, KV, D)
        if int8:
            ps = sc[li][block_table]             # (B, maxp)
            pages = (pages.float() * ps[..., None, None, None]).to(dt)
        return pages.reshape(b, ctx, KV, D)

    def step(kv_k, kv_v, *rest):
        if int8:
            k_sc, v_sc, tokens, positions, block_table = rest
        else:
            tokens, positions, block_table = rest
            k_sc = v_sc = None
        dev = kv_k.device
        b = tokens.shape[0]
        jidx = torch.arange(k1, device=dev)
        tbl = block_table.long()
        tbl32 = block_table.to(torch.int32).contiguous()
        pos32 = positions.to(torch.int32).contiguous()
        x = embed[tokens.long()]                             # (B, k1, U)
        pos = positions.long()[:, None] + jidx[None, :]      # (B, k1)
        cos, sin = _rope_tables(pos.float(), D, g.rope_base)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        rows_b = torch.arange(b, device=dev)
        # an index past the table clamps, as the JAX gather does
        pid = tbl[rows_b[:, None], (pos // S).clamp(max=maxp - 1)]
        slot = pos % S
        valid = torch.arange(ctx, device=dev)[None, None, :] \
            <= pos[..., None]
        for li, lw in enumerate(layers):
            h = _rmsnorm(x, lw["attn_norm"], g.eps)
            q = _rotate(F.linear(h, lw["q"]).reshape(b, k1, H, D), cos, sin)
            k = _rotate(F.linear(h, lw["k"]).reshape(b, k1, KV, D), cos, sin)
            v = F.linear(h, lw["v"]).reshape(b, k1, KV, D)
            append(kv_k, k_sc, li, pid, slot, k, jidx)
            append(kv_v, v_sc, li, pid, slot, v, jidx)
            if kernel:
                sc_args = (k_sc[li], v_sc[li]) if int8 else ()
                att = _paged_attn(q.contiguous(), kv_k[li], kv_v[li],
                                  tbl32, pos32, *sc_args, scale=scale)
            else:
                keys = gather(kv_k, k_sc, li, tbl, b, x.dtype)
                vals = gather(kv_v, v_sc, li, tbl, b, x.dtype)
                qg = q.reshape(b, k1, KV, grp, D)
                scores = torch.einsum("bkvgd,bcvd->bkvgc", qg,
                                      keys.to(qg.dtype)) * scale
                scores = torch.where(valid[:, :, None, None, :],
                                     scores.float(), -1e30)
                probs = torch.softmax(scores, dim=-1).to(x.dtype)
                att = torch.einsum("bkvgc,bcvd->bkvgd", probs, vals) \
                    .reshape(b, k1, H, D)
            x = x + F.linear(att.reshape(b, k1, H * D).to(x.dtype),
                             lw["o"])
            x = _ffn(x, lw, g.eps)
        logits = _logits(x, norm, embed, head, g.eps)        # (B, k1, V)
        if int8:
            return kv_k, kv_v, k_sc, v_sc, logits
        return kv_k, kv_v, logits

    return step


def build_decode_fn(weights, geometry):
    """One batched single-token decode step: the ``k1=1`` slice of
    :func:`build_step_fn` with the historical external signature
    (tokens ``(B,)``, logits ``(B, V)``); int8 geometries insert the
    two scale arrays after the kv buffers."""
    step = build_step_fn(weights, geometry, 1)
    int8 = geometry.quantized

    def decode(kv_k, kv_v, *rest):
        scales, (tokens, positions, block_table) = \
            (rest[:2], rest[2:]) if int8 else ((), rest)
        outs = step(kv_k, kv_v, *scales, tokens[:, None], positions,
                    block_table)
        return outs[:-1] + (outs[-1][:, 0],)

    return decode


def build_verify_fn(weights, geometry):
    """The speculative-decoding signature: ``spec_k + 1`` tokens per
    lane — ``tokens[:, 0]`` is the last accepted token, ``tokens[:,
    1:]`` the drafts — returning logits at every position so the
    scheduler accepts the longest draft prefix the model reproduces."""
    if geometry.spec_k <= 0:
        raise MXNetError("verify needs a geometry with spec_k > 0")
    return build_step_fn(weights, geometry, geometry.spec_k + 1)


def build_prefill_fn(weights, geometry, bucket):
    """Whole-prompt pass for one padded bucket length ``T``.

    ``(kv_k, kv_v, tokens (T,), length, block_table (maxp,)) ->
    (kv_k, kv_v, logits (V,) f32)``; int8 geometries insert
    ``k_scale``/``v_scale`` after the kv buffers in both tuples, as in
    :func:`build_step_fn`.  ``length`` is an int or a 0-d tensor (on the
    arena's device inside a CUDA graph: the body reads nothing back to
    the host).

    Every position's K/V is scattered into the arena (pad positions land
    on the null page or on this sequence's own not-yet-read slots); the
    returned logits are the last real token's.  Attention runs over the
    in-call full-precision K/V, not the arena, so prefill logits are
    identical between float and int8 arenas.
    """
    embed, layers, norm, head = weights
    g = geometry
    H, KV, D, S = g.num_heads, g.num_kv_heads, g.head_dim, g.page_size
    scale = 1.0 / math.sqrt(D)
    t = int(bucket)
    int8 = g.quantized

    def prefill(kv_k, kv_v, *rest):
        if int8:
            k_sc, v_sc, tokens, length, block_table = rest
        else:
            tokens, length, block_table = rest
            k_sc = v_sc = None
        dev = kv_k.device
        x = embed[tokens.long()]                             # (T, U)
        pos = torch.arange(t, device=dev)
        cos, sin = _rope_tables(pos.float(), D, g.rope_base)
        cos, sin = cos[:, None, :], sin[:, None, :]          # (T, 1, half)
        pid = block_table.long()[pos // S]                   # (T,)
        slot = pos % S
        causal = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] < length)                        # (T, T)

        def append(kv, sc, li, rows):
            if not int8:
                kv[li, pid, slot] = rows.to(kv.dtype)
                return
            r32 = rows.float()
            amax = r32.abs().amax(dim=(1, 2))                # (T,)
            # every page start is in-call during prefill: row (p//S)*S
            # fixes page p//S's scale
            first = amax[(pos // S) * S]
            news = torch.clamp_min(
                first * (_INT8_SCALE_HEADROOM / _INT8_QMAX), _INT8_MIN_SCALE)
            kv[li, pid, slot] = _quantize(r32, news)
            sc[li, pid] = news

        for li, lw in enumerate(layers):
            h = _rmsnorm(x, lw["attn_norm"], g.eps)
            q = _rotate(F.linear(h, lw["q"]).reshape(t, H, D), cos, sin)
            k = _rotate(F.linear(h, lw["k"]).reshape(t, KV, D), cos, sin)
            v = F.linear(h, lw["v"]).reshape(t, KV, D)
            append(kv_k, k_sc, li, k)
            append(kv_v, v_sc, li, v)
            # grouped-head attention: queries fold to (T, KV, G, D) so
            # K/V are never replicated H/KV-fold (head h = kv*G + g)
            qg = q.reshape(t, KV, H // KV, D)
            scores = torch.einsum("tvgd,uvd->vgtu", qg, k) * scale
            scores = torch.where(causal[None, None, :, :], scores.float(),
                                 -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            att = torch.einsum("vgtu,uvd->tvgd", probs, v)
            x = x + F.linear(att.reshape(t, H * D).to(x.dtype), lw["o"])
            x = _ffn(x, lw, g.eps)
        # the last real token's row, indexed on the device: indexing by
        # a 0-d tensor would read it to the host, which a CUDA graph
        # capture forbids
        last = (torch.as_tensor(length, device=dev) - 1).reshape(1)
        logits = _logits(x.index_select(0, last.long())[0], norm, embed,
                         head, g.eps)
        if int8:
            return kv_k, kv_v, k_sc, v_sc, logits
        return kv_k, kv_v, logits

    return prefill


def save_serving_bundle(path, raw, geometry):
    """Write a port bundle: one ``.npz`` holding the ``(embed, layers,
    norm, head)`` numpy weights (as :func:`convert_weights` takes them)
    plus the geometry dict.  No pickle; written atomically."""
    embed, layers, norm, head = raw
    if len(layers) != geometry.num_layers:
        raise MXNetError("bundle has %d layers but the geometry says %d"
                         % (len(layers), geometry.num_layers))
    arrays = {"embed": np.asarray(embed), "norm": np.asarray(norm)}
    if head is not None:
        arrays["head"] = np.asarray(head)
    for i, lw in enumerate(layers):
        for k in _LAYER_KEYS:
            arrays["layer%d.%s" % (i, k)] = np.asarray(lw[k])
    meta = {"kind": BUNDLE_KIND, "format": BUNDLE_FORMAT,
            "geometry": geometry.to_dict()}
    arrays["meta"] = np.array(json.dumps(meta))
    with atomic_path(path) as tmp:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    return geometry


def load_serving_bundle(path, expect=None):
    """Read a port bundle: ``(KVGeometry, raw)`` with ``raw`` the numpy
    ``(embed, layers, norm, head)`` tuple.  The geometry is validated
    here, and checked field by field against ``expect`` when given."""
    if not os.path.exists(path):
        raise MXNetError("no serving bundle at %s" % path)
    with np.load(path, allow_pickle=False) as z:
        if "meta" not in z.files:
            raise MXNetError("%s is not a port serving bundle (no meta)"
                             % path)
        meta = json.loads(str(z["meta"]))
        if meta.get("kind") != BUNDLE_KIND \
                or meta.get("format") != BUNDLE_FORMAT:
            raise MXNetError(
                "%s is not a port serving bundle (kind=%r format=%r) — "
                "write one with serve.save_serving_bundle"
                % (path, meta.get("kind"), meta.get("format")))
        g = KVGeometry.from_dict(meta.get("geometry", {}), origin=path)
        if expect is not None:
            check_geometry(g, expect, origin=path)
        layers = [{k: z["layer%d.%s" % (i, k)] for k in _LAYER_KEYS}
                  for i in range(g.num_layers)]
        raw = (z["embed"], layers, z["norm"],
               z["head"] if "head" in z.files else None)
    return g, raw


def check_geometry(got, expect, origin="bundle"):
    """Field-by-field KV geometry comparison with a clear error.

    ``expect``: KVGeometry or a dict of the subset to pin (e.g.
    ``{"page_size": 16, "dtype": "float32"}``).
    """
    exp = expect.to_dict() if isinstance(expect, KVGeometry) else dict(expect)
    gd = got.to_dict()
    bad = []
    for field, want in exp.items():
        if field not in gd:
            raise MXNetError("%s: unknown geometry field %r" % (origin,
                                                                field))
        have = gd[field]
        if field == "prefill_buckets":
            want = list(want)
        if have != want:
            bad.append("%s: bundle has %r, caller expects %r"
                       % (field, have, want))
    if bad:
        raise MXNetError(
            "%s: KV-page geometry mismatch — refusing to serve (this "
            "would fail inside XLA on the first decode):\n  %s"
            % (origin, "\n  ".join(bad)))
