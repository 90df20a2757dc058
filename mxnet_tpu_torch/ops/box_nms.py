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

On a CUDA tensor it launches the hand-written kernels of
``csrc/box_nms.cu`` (built by ``ops/_build.py`` at first use) or raises;
on a CPU tensor it runs the plain version ``nms_keep_ref``, the same loop
one row of IoUs at a time.  The size rule (``route_for``): an image of at
most ``CLUSTER_MAX_BOXES`` boxes takes the cluster route, one launch in
which a cluster of 8 CTAs holds the image in shared memory and
walks it, computing only the IoUs of kept boxes; a larger one takes the
two-pass route, a parallel pass of 64-bit suppression words over every
pair and one sequential scan an image.  Every route rounds each IoU as
``inter / max(area_l + area_r - inter, 1e-12)`` in that order, so the
keep masks are equal bit for bit.  The wrapper allocates the outputs and
the two-pass route's workspace and never reads the card from the host,
so a call can be captured in a CUDA graph.
``nms_keep.launches`` counts the wrapper's kernel launches
(``graph_cache.count``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import graph_cache as _graph_cache
from ..base import MXNetError
from . import _build

_SOURCE = _build.source_path("box_nms.cu")
# the cluster route's size rule: an image's boxes, areas and tiles in the
# shared memory of one cluster of 8 CTAs (csrc/box_nms.cu,
# kClusterMaxWords 64-box words)
CLUSTER_MAX_BOXES = 16384


def route_for(n):
    """The route an image of ``n`` boxes takes on the card: ``"cluster"``
    up to ``CLUSTER_MAX_BOXES``, ``"two_pass"`` above."""
    return "cluster" if n <= CLUSTER_MAX_BOXES else "two_pass"


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
    lib.mxtt_nms_cluster.argtypes = [p, p, i, i, f, p, p,
                                     ctypes.POINTER(i)]
    lib.mxtt_nms_cluster.restype = i
    lib.mxtt_nms_mask_pass.argtypes = [p, i, i, f, p, p, ctypes.POINTER(i)]
    lib.mxtt_nms_mask_pass.restype = i
    lib.mxtt_nms_scan_pass.argtypes = [p, p, i, i, p, p, ctypes.POINTER(i)]
    lib.mxtt_nms_scan_pass.restype = i
    for fn in (lib.mxtt_nms_words, lib.mxtt_nms_max_boxes,
               lib.mxtt_nms_cluster_max_boxes):
        fn.restype = i
    lib.mxtt_nms_words.argtypes = [i]
    lib.mxtt_nms_max_boxes.argtypes = []
    lib.mxtt_nms_cluster_max_boxes.argtypes = []
    lib.mxtt_nms_error_string.argtypes = [i]
    lib.mxtt_nms_error_string.restype = ctypes.c_char_p


def _load():
    return _build.load(_SOURCE, _bind)


def nms_keep(boxes, valid, overlap_thresh):
    """O4: the greedy keep mask (B, N) bool of ``boxes`` (B, N, 4),
    sorted by score, in corner format, and ``valid`` (B, N) bool (see the
    module docstring).  CPU tensors run the plain version; CUDA tensors
    (float32 boxes) launch the kernels of the size rule's route or
    raise."""
    return _nms_keep(boxes, valid, overlap_thresh, None)


def _nms_keep(boxes, valid, overlap_thresh, route):
    """``nms_keep`` through ``route`` (``"cluster"`` or ``"two_pass"``;
    None: the size rule's), so that checks can hold each route to the
    plain version."""
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
    if boxes.shape[0] == 0 or boxes.shape[1] == 0:
        return torch.zeros(tuple(valid.shape), dtype=torch.bool, device=dev)
    keep = _launch(boxes, valid, overlap_thresh,
                   route_for(boxes.shape[1]) if route is None else route)
    _graph_cache.count(nms_keep, "launches")
    return keep.bool()


def _launch(boxes, valid, overlap_thresh, route):
    """Launch ``route``'s kernels on (B, N, 4) f32 CUDA ``boxes``;
    returns the keep flags (B, N) uint8.  Raises where the library
    refuses."""
    lib = _load()
    dev = boxes.device
    b, n = boxes.shape[0], boxes.shape[1]
    limit = {"cluster": lib.mxtt_nms_cluster_max_boxes(),
             "two_pass": lib.mxtt_nms_max_boxes()}.get(route)
    if limit is None:
        raise MXNetError("box_nms route %r: cluster or two_pass" % (route,))
    if n > limit:
        raise MXNetError("the box_nms %s route takes at most %d boxes an "
                         "image, got %d" % (route, limit, n))
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    valid = valid.to(torch.uint8).contiguous()
    keep = torch.empty(b, n, dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "cluster":
            err = lib.mxtt_nms_cluster(boxes.data_ptr(), valid.data_ptr(), b,
                                       n, float(overlap_thresh),
                                       keep.data_ptr(), stream,
                                       ctypes.byref(launched))
        else:
            mask = torch.empty(b * n * lib.mxtt_nms_words(n),
                               dtype=torch.int64, device=dev)
            err = lib.mxtt_box_nms(boxes.data_ptr(), valid.data_ptr(), b, n,
                                   float(overlap_thresh), mask.data_ptr(),
                                   keep.data_ptr(), stream,
                                   ctypes.byref(launched))
    if err != 0:
        raise MXNetError("box_nms kernel launch failed: %d (%s)"
                         % (err, lib.mxtt_nms_error_string(err).decode()))
    return keep


nms_keep.launches = 0


def two_pass_passes(boxes, valid, overlap_thresh):
    """The two-pass route's passes as separate launches over one
    workspace, for timing each alone: returns ``(mask_pass, scan_pass,
    keep)``; ``mask_pass()`` writes the suppression words of ``boxes``
    (B, N, 4) f32 on the card, ``scan_pass()`` walks them into ``keep``
    (B, N) uint8.  Not counted in ``nms_keep.launches``."""
    lib = _load()
    b, n = boxes.shape[0], boxes.shape[1]
    boxes = boxes.contiguous().clone()
    valid = valid.to(torch.uint8).contiguous()
    mask = torch.empty(b * n * lib.mxtt_nms_words(n), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty(b, n, dtype=torch.uint8, device=boxes.device)
    launched = ctypes.c_int(0)

    def check(err):
        if err != 0:
            raise MXNetError("box_nms pass failed: %d (%s)"
                             % (err, lib.mxtt_nms_error_string(err).decode()))

    def stream():
        return torch.cuda.current_stream(boxes.device).cuda_stream

    def mask_pass():
        check(lib.mxtt_nms_mask_pass(boxes.data_ptr(), b, n,
                                     float(overlap_thresh), mask.data_ptr(),
                                     stream(), ctypes.byref(launched)))

    def scan_pass():
        check(lib.mxtt_nms_scan_pass(mask.data_ptr(), valid.data_ptr(), b, n,
                                     keep.data_ptr(), stream(),
                                     ctypes.byref(launched)))

    return mask_pass, scan_pass, keep
