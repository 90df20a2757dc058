"""O4 ``box_nms``: greedy non-maximum suppression, the port-only kernel
behind ``_contrib_box_nms`` and ``_contrib_MultiBoxDetection``.

No Pallas kernel stands behind it.  The JAX package's ``_box_nms``
(``mxnet_tpu/ops/contrib.py:85-112``) builds each image's full (N, N)
IoU matrix and runs the greedy loop as one ``lax.fori_loop``; eagerly in
torch that loop is several launches a box.  ``nms_keep`` takes the boxes
already sorted by score (corner format) and ``valid0`` (score above the
valid threshold) and returns the greedy keep mask:

    keep = valid0
    for i in range(N):
        keep &= ~(keep[i] & (iou[i] > overlap_thresh) & (j > i))

On a CUDA tensor it launches the hand-written kernel of
``csrc/box_nms.cu`` (built by ``ops/_build.py`` at first use: a parallel
pass of 64-bit suppression words, then one sequential scan an image) or
raises; on a CPU tensor it runs the plain version ``nms_keep_ref``, the
same loop one row of IoUs at a time.  Both round each IoU as
``inter / max(area_l + area_r - inter, 1e-12)`` in that order, so their
keep masks are equal bit for bit.  ``nms_keep.launches`` counts the
wrapper's kernel launches (``graph_cache.count``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build

_SOURCE = _build.source_path("box_nms.cu")


def iou(lhs, rhs):
    """IoU of corner boxes ``lhs`` and ``rhs`` (broadcast over their
    leading dims), rounded as the JAX package's ``_box_iou``."""
    tl = torch.maximum(lhs[..., :2], rhs[..., :2])
    br = torch.minimum(lhs[..., 2:], rhs[..., 2:])
    wh = (br - tl).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (lhs[..., 2] - lhs[..., 0]) * (lhs[..., 3] - lhs[..., 1])
    area_r = (rhs[..., 2] - rhs[..., 0]) * (rhs[..., 3] - rhs[..., 1])
    return inter / (area_l + area_r - inter).clamp_min(1e-12)


def nms_keep_ref(boxes, valid, overlap_thresh):
    """The plain version of O4: ``boxes`` (B, N, 4) sorted corner boxes,
    ``valid`` (B, N) bool; returns the keep mask (B, N) bool."""
    n = boxes.shape[1]
    keep = valid.clone()
    idx = torch.arange(n, device=boxes.device)
    for i in range(n):
        row = iou(boxes[:, i:i + 1, :], boxes)               # (B, N)
        sup = keep[:, i:i + 1] & (row > overlap_thresh) & (idx > i)
        keep &= ~sup
    return keep


def build(verbose=False):
    """Compile ``csrc/box_nms.cu`` with nvcc (when its library is not
    built yet) and return its path."""
    return _build.build(_SOURCE, verbose=verbose)


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mxtt_box_nms.argtypes = [p, p, i, i, f, p, p, p,
                                 ctypes.POINTER(i)]
    lib.mxtt_box_nms.restype = i
    for fn in (lib.mxtt_nms_words, lib.mxtt_nms_max_boxes):
        fn.restype = i
    lib.mxtt_nms_words.argtypes = [i]
    lib.mxtt_nms_max_boxes.argtypes = []
    lib.mxtt_nms_error_string.argtypes = [i]
    lib.mxtt_nms_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def nms_keep(boxes, valid, overlap_thresh):
    """O4: the greedy keep mask (B, N) bool of ``boxes`` (B, N, 4),
    sorted by score, in corner format, and ``valid`` (B, N) bool (see the
    module docstring).  CPU tensors run the plain version; CUDA tensors
    (float32 boxes) launch the kernel or raise."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise MXNetError("box_nms wants boxes (B, N, 4) and valid (B, N), "
                         "got %s and %s" % (tuple(boxes.shape),
                                            tuple(valid.shape)))
    dev = boxes.device
    if dev.type == "cpu":
        return nms_keep_ref(boxes, valid, overlap_thresh)
    if dev.type != "cuda":
        raise MXNetError("box_nms runs on cuda or cpu tensors, got %s" % dev)
    if boxes.dtype != torch.float32:
        raise MXNetError("the box_nms kernel takes float32 boxes, got %s"
                         % boxes.dtype)
    b, n = boxes.shape[0], boxes.shape[1]
    keep = torch.empty(b, n, dtype=torch.uint8, device=dev)
    if b == 0 or n == 0:
        return keep.bool()
    lib = _load()
    if n > lib.mxtt_nms_max_boxes():
        raise MXNetError("the box_nms kernel takes at most %d boxes an "
                         "image, got %d" % (lib.mxtt_nms_max_boxes(), n))
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    valid = valid.to(torch.uint8).contiguous()
    words = lib.mxtt_nms_words(n)
    mask = torch.empty(b * n * words, dtype=torch.int64, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxtt_box_nms(boxes.data_ptr(), valid.data_ptr(), b, n,
                               float(overlap_thresh), mask.data_ptr(),
                               keep.data_ptr(), stream,
                               ctypes.byref(launched))
    if err != 0:
        raise MXNetError("box_nms kernel launch failed: %d (%s)"
                         % (err, lib.mxtt_nms_error_string(err).decode()))
    _graph_cache.count(nms_keep, "launches")
    return keep.bool()


nms_keep.launches = 0
