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
``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

_SOURCE = _build.source_path("paged_attention.cu")
MAX_HEAD_DIM = 256
MAX_TABLE_WIDTH = 16384   # a block keeps its lane's table row in smem

# dtype codes of the C interface
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _paged_ref(q, k_pages, v_pages, block_table, positions, *scales,
               scale):
    """Plain PyTorch version: gather + (dequant) + grouped-GQA attention.

    The same masking as the kernel (position AND null page); the softmax
    is the two-pass form with fully masked rows guarded to zero output.
    f32 arithmetic, output in ``q``'s dtype.
    """
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
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    att = torch.einsum("bkvgc,bcvd->bkvgd",
                       p / torch.where(l == 0, torch.ones_like(l), l), vals)
    return att.reshape(b, k1, h, d).to(q.dtype)


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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    out = torch.empty_like(q)
    ks, vs = (scales[0].data_ptr(), scales[1].data_ptr()) if scales \
        else (None, None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        paged_attention.launches += 1
        err = lib.mxtt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), positions.data_ptr(), ks, vs,
            out.data_ptr(), b, k1, h, kv, d, s_page, block_table.shape[1],
            float(scale), _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype],
            stream)
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
