"""Paged attention over the serve arena's block tables (K4 of the port).

``paged_attention`` attends ``(B, k1, H, D)`` queries against
``(P, S, KV, D)`` K/V pages addressed by a ``(B, maxp)`` int32 block
table, one position per lane.  Query ``j`` of lane ``b`` sits at
``positions[b] + j`` and attends context ``<= positions[b] + j`` on the
lane's pages; page 0 is the arena's null page and is always masked;
``k_scale``/``v_scale`` ``(P,)`` f32 dequantize int8 pages; a fully
masked query row returns 0.  ``k1`` is 1 for decode, ``spec_k + 1`` for
speculative verify and the chunk width for chunked prefill.

Dispatch is by the device of the tensors, never by a fallback: CPU
tensors go to the plain PyTorch version :func:`_paged_ref`; CUDA tensors
go to the hand-written Hopper kernel in ``csrc/paged_attention.cu``
(which replaces the JAX package's Pallas ``_paged_kernel``) or the call
raises.  The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``build/`` at the repo root on first use (``ops/_build.py``) and bound
with ``ctypes``.
At decode only ``B * KV * row_tiles`` (lane, kv-head, row tile) blocks
would run, fewer than the card's SMs, so the wrapper splits each lane's
context over ``n_split`` blocks (:func:`n_split`, picked from the launch
shape alone) and a second small kernel combines the splits' partial
softmax states in a fixed order; the f32 scratch for them is allocated
here.  ``paged_attention.launches`` counts calls that launched the
kernel, ``paged_attention.combine_launches`` the combine launches among
them; both are counted under a lock, since several serve loops (a
fleet's replicas in one process) launch from their own threads, and
launches replayed in a captured CUDA graph count too
(``graph_cache.count``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build
from .registry import register

_SOURCE = _build.source_path("paged_attention.cu")
MAX_HEAD_DIM = 256
MAX_TABLE_WIDTH = 16384   # a block keeps its lane's table row in smem

# dtype codes of the C interface
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

KEYS_PER_STEP = 32   # the kernel's step: one key per lane of a warp
MAX_SPLIT = 16
# the split aims at this many blocks per SM
SPLIT_BLOCKS_PER_SM = 3


def _row_tile(rows):
    """The kernel's row tile for ``rows = k1 * G`` query rows of a
    kv-head (mirrors ``launch`` in the .cu)."""
    return 4 if rows <= 4 else 8 if rows <= 8 else 16


def n_split(batch, k1, num_heads, num_kv_heads, page_size, table_width,
            sms):
    """Blocks each (lane, kv-head, row tile) is split over: enough for
    about ``SPLIT_BLOCKS_PER_SM * sms`` blocks in all, at most
    ``MAX_SPLIT`` and at most the 32-key steps of the table width; 1 (no
    split, no combine) once the unsplit grid fills the card.  Three
    blocks an SM was the fastest at the 8-lane decode shape
    (``tools/torch_paged_variants.py``)."""
    tiles = -(-k1 * (num_heads // num_kv_heads)
              // _row_tile(k1 * (num_heads // num_kv_heads)))
    blocks = batch * num_kv_heads * tiles
    steps = -(-table_width * page_size // KEYS_PER_STEP)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // blocks)
    return max(1, min(MAX_SPLIT, steps, want))


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """The SM count of CUDA device ``index`` (cached)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _paged_scores(q, k_pages, v_pages, block_table, positions, *scales,
                  scale):
    """Gather + (dequant) + grouped-GQA scores, masked (position AND null
    page) to -inf: ``(s (B, k1, KV, G, ctx), values (B, ctx, KV, D))``."""
    b, k1, h, d = q.shape
    s_page, kv = k_pages.shape[1], k_pages.shape[2]
    maxp = block_table.shape[1]
    grp = h // kv
    ctx = maxp * s_page
    tbl = block_table.long()
    keys = k_pages[tbl].float()                     # (B, maxp, S, KV, D)
    vals = v_pages[tbl].float()
    if scales:
        ks, vs = scales
        keys = keys * ks[tbl][..., None, None, None]
        vals = vals * vs[tbl][..., None, None, None]
    keys = keys.reshape(b, ctx, kv, d)
    vals = vals.reshape(b, ctx, kv, d)
    qg = q.float().reshape(b, k1, kv, grp, d)
    s = torch.einsum("bkvgd,bcvd->bkvgc", qg, keys) * scale
    posk = positions.long()[:, None] \
        + torch.arange(k1, device=q.device)[None, :]          # (B, k1)
    ok = (torch.arange(ctx, device=q.device)[None, None, :]
          <= posk[..., None]) \
        & torch.repeat_interleave(tbl != 0, s_page, dim=1)[:, None, :]
    s = torch.where(ok[:, :, None, None, :], s,
                    torch.tensor(float("-inf"), device=q.device))
    return s, vals


def _paged_ref(q, k_pages, v_pages, block_table, positions, *scales,
               scale):
    """Plain PyTorch version: gather + (dequant) + grouped-GQA attention.

    The same masking as the kernel (position AND null page); the softmax
    is the two-pass form with fully masked rows guarded to zero output.
    f32 arithmetic, output in ``q``'s dtype.
    """
    s, vals = _paged_scores(q, k_pages, v_pages, block_table, positions,
                            *scales, scale=scale)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    att = torch.einsum("bkvgc,bcvd->bkvgd",
                       p / torch.where(l == 0, torch.ones_like(l), l), vals)
    return att.reshape(q.shape).to(q.dtype)


def _paged_split_ref(q, k_pages, v_pages, block_table, positions, *scales,
                     scale, n_split):
    """The split arithmetic of the kernel, in plain PyTorch (tests only):
    split ``s`` takes the 32-key steps ``s, s + n_split, ...`` and keeps
    its own ``(acc, m, l)``, unnormalized; the splits combine in order as
    ``sum exp(m_s - M) acc_s / sum exp(m_s - M) l_s`` with ``M`` the
    largest ``m_s``, and a row no split saw returns 0."""
    s, vals = _paged_scores(q, k_pages, v_pages, block_table, positions,
                            *scales, scale=scale)
    ctx = s.shape[-1]
    owner = torch.arange(ctx, device=q.device) // KEYS_PER_STEP % n_split
    neg = torch.tensor(float("-inf"), device=q.device)
    parts = []
    for split in range(n_split):
        ss = torch.where(owner == split, s, neg)
        m = ss.amax(dim=-1, keepdim=True)        # -inf: the split saw none
        p = torch.exp(ss - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m)))
        parts.append((torch.einsum("bkvgc,bcvd->bkvgd", p, vals), m,
                      p.sum(dim=-1, keepdim=True)))
    big = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    seen = torch.isfinite(big)
    big = torch.where(seen, big, torch.zeros_like(big))
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][2])
    for acc, m, l in parts:
        w = torch.exp(m - big)                   # 0 for an empty split
        num = num + w * acc
        den = den + w * l
    att = torch.where(seen, num / torch.where(seen, den, torch.ones_like(den)),
                      torch.zeros_like(num))
    return att.reshape(q.shape).to(q.dtype)


def library_path():
    """Where the built kernel library lives: ``build/`` at the repo root,
    named by a hash of the source and flags so an edit rebuilds."""
    return _build.library_path(_SOURCE)


def build(verbose=False):
    """Compile ``csrc/paged_attention.cu`` with nvcc (when the library
    for this source is not built yet) and return its path."""
    return _build.build(_SOURCE, verbose=verbose)


def _bind(lib):
    fn = lib.mxtt_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mxtt_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def _check_cuda_args(q, k_pages, v_pages, block_table, positions, scales):
    dev = q.device
    named = [("query", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("block_table", block_table), ("positions", positions)]
    named += list(zip(("k_scale", "v_scale"), scales))
    for name, t in named:
        if t.device != dev:
            raise MXNetError("paged_attention: %s is on %s, query on %s"
                             % (name, t.device, dev))
        if not t.is_contiguous():
            raise MXNetError("paged_attention: %s must be contiguous"
                             % name)
    if q.dtype not in _Q_CODES:
        raise MXNetError("paged_attention kernel takes float32 or bfloat16 "
                         "queries, got %s" % q.dtype)
    if k_pages.dtype not in _KV_CODES or v_pages.dtype != k_pages.dtype:
        raise MXNetError("paged_attention kernel takes float32, bfloat16 "
                         "or int8 pages (K and V alike), got %s / %s"
                         % (k_pages.dtype, v_pages.dtype))
    if k_pages.dtype == torch.int8 and not scales:
        raise MXNetError("int8 pages need k_scale and v_scale")
    for name, t in zip(("k_scale", "v_scale"), scales):
        if t.dtype != torch.float32 or t.shape != (k_pages.shape[0],):
            raise MXNetError("paged_attention: %s must be float32 (P,)=%s, "
                             "got %s %s" % (name, (k_pages.shape[0],),
                                            t.dtype, tuple(t.shape)))
    if block_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise MXNetError("paged_attention: block_table and positions must "
                         "be int32")
    if block_table.shape[1] > MAX_TABLE_WIDTH:
        raise MXNetError("paged_attention kernel takes block tables up to "
                         "%d pages wide, got %d"
                         % (MAX_TABLE_WIDTH, block_table.shape[1]))
    if q.shape[3] > MAX_HEAD_DIM:
        raise MXNetError("paged_attention kernel takes head_dim <= %d, got "
                         "%d" % (MAX_HEAD_DIM, q.shape[3]))


def _launch(q, k_pages, v_pages, block_table, positions, scales, scale):
    _check_cuda_args(q, k_pages, v_pages, block_table, positions, scales)
    lib = _load()
    b, k1, h, d = q.shape
    s_page, kv = k_pages.shape[1], k_pages.shape[2]
    maxp = block_table.shape[1]
    splits = n_split(b, k1, h, kv, s_page, maxp, sm_count(q.device.index))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        # one f32 scratch: (splits, rows, D) accumulators, then (splits,
        # rows, 2) running max and sum
        n_acc = splits * b * k1 * h * d
        scratch = torch.empty(n_acc + splits * b * k1 * h * 2,
                              dtype=torch.float32, device=q.device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
    ks, vs = (scales[0].data_ptr(), scales[1].data_ptr()) if scales \
        else (None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _graph_cache.count(paged_attention, "launches")
        _graph_cache.count(paged_attention, "combine_launches",
                           int(splits > 1))
        err = lib.mxtt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), positions.data_ptr(), ks, vs,
            out.data_ptr(), part_acc, part_ml, b, k1, h, kv, d,
            s_page, maxp, float(scale), _Q_CODES[q.dtype],
            _KV_CODES[k_pages.dtype], splits, stream)
    if err != 0:
        raise MXNetError("paged_attention kernel launch failed: CUDA error "
                         "%d (%s)" % (err, lib.mxtt_error_string(err).decode()))
    return out


def paged_attention(query, k_pages, v_pages, block_table, positions,
                    k_scale=None, v_scale=None, scale=None):
    """Paged attention (see the module docstring).  ``scale`` defaults
    to ``1/sqrt(D)``.  CPU tensors run the plain version; CUDA tensors
    launch the Hopper kernel or raise."""
    if (k_scale is None) != (v_scale is None):
        raise MXNetError("paged_attention needs both k_scale and v_scale "
                         "or neither")
    if query.dim() != 4 or k_pages.dim() != 4:
        raise MXNetError(
            "paged_attention wants query (B, k1, H, D) and pages "
            "(P, S, KV, D); got %s / %s"
            % (tuple(query.shape), tuple(k_pages.shape)))
    h, d = query.shape[2], query.shape[3]
    kv = k_pages.shape[2]
    if h % kv or k_pages.shape[3] != d or v_pages.shape != k_pages.shape:
        raise MXNetError(
            "paged_attention: %d query heads do not group over %d kv heads "
            "(head_dim %d vs %d, v pages %s)"
            % (h, kv, d, k_pages.shape[3], tuple(v_pages.shape)))
    if block_table.dim() != 2 or positions.shape != (query.shape[0],) \
            or block_table.shape[0] != query.shape[0]:
        raise MXNetError(
            "paged_attention wants block_table (B, maxp) and positions "
            "(B,) for B=%d; got %s / %s" % (query.shape[0],
                                            tuple(block_table.shape),
                                            tuple(positions.shape)))
    if scale is None or scale == 0:
        scale = 1.0 / (d ** 0.5)
    scales = () if k_scale is None else (k_scale, v_scale)
    if query.device.type == "cuda":
        return _launch(query, k_pages, v_pages, block_table, positions,
                       scales, scale)
    if query.device.type != "cpu":
        raise MXNetError("paged_attention runs on cuda or cpu tensors, got "
                         "%s" % query.device)
    return _paged_ref(query, k_pages, v_pages, block_table, positions,
                      *(s.float() for s in scales), scale=float(scale))


paged_attention.launches = 0
paged_attention.combine_launches = 0


@register("_contrib_paged_attention",
          inputs=("query", "k_pages", "v_pages", "block_table",
                  "positions", "k_scale", "v_scale"))
def _paged_attention_op(query, k_pages, v_pages, block_table, positions,
                        k_scale=None, v_scale=None, scale=None,
                        use_kernel=None):
    """The JAX package's registered op (``mxnet_tpu/ops/
    paged_attention.py:190``): ``paged_attention`` with the block table
    and positions taken as int32.  ``use_kernel`` is accepted and
    ignored: CUDA arrays launch K4, CPU arrays run the plain version."""
    del use_kernel
    return paged_attention(query, k_pages, v_pages,
                           block_table.to(torch.int32),
                           positions.to(torch.int32), k_scale, v_scale,
                           scale)
