"""Vision and detection operators: the ROI pooling family, deformable
convolution, the SSD MultiBox ops, RPN proposals, the box codecs,
bipartite matching and ``SyncBatchNorm``.

The port's counterpart of the JAX package's ``ops/vision.py``, op for op,
with its names, attributes, defaults and formulas: what the JAX package
maps over ROIs or images with ``vmap`` is one batched torch computation
here, and its ``fori_loop``s are Python loops of a fixed count (the
number of ground-truth boxes, of matches), so every op but ``Proposal``'s
anchors runs on the device without a host read and captures into a CUDA
graph.  ROI windows are per-axis membership masks, as in the JAX
package; bilinear sampling gathers the four neighbours.

``MultiBoxTarget``'s greedy matching takes the first maximum of the
flat (anchors, ground truths) matrix, as ``jnp.argmax`` does, and its
hard negatives rank by a stable ascending sort of the negated score, as
``jnp.argsort(-score)``.  ``MultiBoxDetection`` and ``Proposal`` keep
their boxes with O4 (``ops/box_nms.py``): the CUDA C++ kernel on the
card, its plain version on the host.  As in the JAX package,
``MultiBoxDetection`` gives a row under ``threshold`` the class -1 but
keeps it in the NMS (ROADMAP.md R7).  ``_contrib_SyncBatchNorm`` is
``BatchNorm`` over the channel axis on one device; a sharded batch is
slice S8.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import box_nms as _nms
from .nn import _batch_norm
from .registry import alias, register

_NEG = -1e30


def _f32(x):
    """A Python number rounded to f32, as a weakly typed constant meets
    an f32 array in the JAX package."""
    return float(np.float32(x))


def _take_batch(data, b):
    return data[b.to(torch.int64)]


def _axis_masks(start, end, size, bins):
    """(R, bins, size) membership masks of the windows
    [floor(start + i*bin), ceil(start + (i+1)*bin)) of each ROI."""
    i = torch.arange(bins, dtype=torch.float32, device=start.device)
    binw = ((end - start) / bins)[:, None]
    lo = torch.floor(start[:, None] + i[None] * binw)[..., None]
    hi = torch.ceil(start[:, None] + (i[None] + 1) * binw)[..., None]
    pos = torch.arange(size, dtype=torch.float32, device=start.device)
    return (pos >= lo) & (pos < hi)


@register("ROIPooling", aliases=("roi_pooling",))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max pooling over quantized ROI bins (reference: roi_pooling.cc);
    an empty bin gives 0."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    n, c, h, w = data.shape
    r = rois.to(torch.float32)
    img = _take_batch(data, r[:, 0])                        # (R, C, H, W)
    x1 = torch.round(r[:, 1] * spatial_scale)
    y1 = torch.round(r[:, 2] * spatial_scale)
    x2 = torch.round(r[:, 3] * spatial_scale)
    y2 = torch.round(r[:, 4] * spatial_scale)
    hmask = _axis_masks(y1, torch.maximum(y2 + 1, y1 + 1), h, ph)
    wmask = _axis_masks(x1, torch.maximum(x2 + 1, x1 + 1), w, pw)
    neg = torch.tensor(_NEG, dtype=data.dtype, device=data.device)
    t = torch.where(hmask[:, :, None, :, None], img[:, None], neg) \
        .amax(dim=3)                                        # (R, ph, C, W)
    out = torch.where(wmask[:, :, None, None, :], t[:, None], neg) \
        .amax(dim=4)                                        # (R, pw, ph, C)
    out = out.permute(0, 3, 2, 1)
    return torch.where(out <= _NEG / 2, torch.zeros_like(out), out) \
        .to(data.dtype)


def _gather_points(img, yi, xi):
    """``img`` (R, C, H, W) at integer coords (R, P), clipped into the
    map -> (R, C, P)."""
    r, c, h, w = img.shape
    yc = yi.clamp(0, h - 1).to(torch.int64)
    xc = xi.clamp(0, w - 1).to(torch.int64)
    idx = (yc * w + xc)[:, None, :].expand(r, c, yi.shape[1])
    return torch.gather(img.reshape(r, c, h * w), 2, idx)


def _roi_align_points(img, ys, xs):
    """Bilinear samples of (R, C, H, W) at float coords (R, P) -> (R, C,
    P); the border repeats, and a point more than one pixel outside the
    map gives 0."""
    h, w = img.shape[2], img.shape[3]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    inside = ((ys >= -1) & (ys <= h) & (xs >= -1) & (xs <= w)).to(
        img.dtype)[:, None]
    val = (_gather_points(img, y0, x0) * ((1 - wy) * (1 - wx))
           + _gather_points(img, y0, x0 + 1) * ((1 - wy) * wx)
           + _gather_points(img, y0 + 1, x0) * (wy * (1 - wx))
           + _gather_points(img, y0 + 1, x0 + 1) * (wy * wx))
    return val * inside


@register("_contrib_ROIAlign")
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, position_sensitive=False, aligned=False):
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    sr = int(sample_ratio) if int(sample_ratio) > 0 else 2
    n, c, h, w = data.shape
    off = 0.5 if aligned else 0.0
    r = rois.to(torch.float32)
    nr = r.shape[0]
    dev = data.device
    img = _take_batch(data, r[:, 0])
    x1 = r[:, 1] * spatial_scale - off
    y1 = r[:, 2] * spatial_scale - off
    rw = (r[:, 3] * spatial_scale - off - x1).clamp_min(1.0)
    rh = (r[:, 4] * spatial_scale - off - y1).clamp_min(1.0)
    bh, bw = (rh / ph)[:, None, None], (rw / pw)[:, None, None]
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sy = torch.arange(sr, dtype=torch.float32, device=dev)
    ys = y1[:, None, None] + (iy[:, None] + (sy[None, :] + 0.5) / sr) * bh
    xs = x1[:, None, None] + (ix[:, None] + (sy[None, :] + 0.5) / sr) * bw
    yy = ys[:, :, None, :, None].expand(nr, ph, pw, sr, sr)
    xx = xs[:, None, :, None, :].expand(nr, ph, pw, sr, sr)
    pts = _roi_align_points(img, yy.reshape(nr, -1), xx.reshape(nr, -1))
    out = pts.reshape(nr, c, ph, pw, sr * sr).mean(dim=4)
    if position_sensitive:
        # channel (d, i, j) layout: c = (d * ph + i) * pw + j
        d = c // (ph * pw)
        out = out.reshape(nr, d, ph, pw, ph, pw)
        i = torch.arange(ph, device=dev)[:, None]
        j = torch.arange(pw, device=dev)[None, :]
        out = out[:, :, i, j, i, j]
    return out.to(data.dtype)


def _ps_channels(od, gs, ps, dev):
    gi = (torch.arange(ps, device=dev) * gs) // ps
    d = torch.arange(od, device=dev)
    return (d[:, None, None] * gs + gi[None, :, None]) * gs \
        + gi[None, None, :]


def _pick_ps(avg, od, gs, ps):
    """avg (R, C, ps, ps) -> the position-sensitive channel of each bin
    (R, od, ps, ps)."""
    dev = avg.device
    chan = _ps_channels(od, gs, ps, dev)
    i = torch.arange(ps, device=dev)[None, :, None]
    j = torch.arange(ps, device=dev)[None, None, :]
    return avg[:, chan, i, j]


@register("_contrib_PSROIPooling")
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=1, group_size=0):
    """Position-sensitive average ROI pooling (reference:
    contrib/psroi_pooling.cc); channel (d, gi, gj) -> (d*gs + gi)*gs + gj."""
    ps = int(pooled_size)
    gs = int(group_size) if int(group_size) > 0 else ps
    od = int(output_dim)
    n, c, h, w = data.shape
    r = rois.to(torch.float32)
    img = _take_batch(data, r[:, 0])
    x1 = torch.round(r[:, 1]) * spatial_scale
    y1 = torch.round(r[:, 2]) * spatial_scale
    x2 = torch.round(r[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(r[:, 4] + 1.0) * spatial_scale
    rh = (y2 - y1).clamp_min(0.1)
    rw = (x2 - x1).clamp_min(0.1)
    hm = _axis_masks(y1, y1 + rh, h, ps).to(img.dtype)
    wm = _axis_masks(x1, x1 + rw, w, ps).to(img.dtype)
    sums = torch.einsum("rih,rchw,rjw->rcij", hm, img, wm)
    cnt = torch.einsum("rih,rjw->rij", hm, wm).clamp_min(1.0)
    avg = sums / cnt[:, None]
    return _pick_ps(avg, od, gs, ps).to(data.dtype)


@register("_contrib_DeformablePSROIPooling")
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1, trans_std=0.0,
                              no_trans=False):
    """Deformable position-sensitive ROI pooling (reference:
    contrib/deformable_psroi_pooling.cc) via per-bin sampled averages;
    ``(out, zeros)``.  The sampling points pair each bin's i-th y offset
    with its i-th x offset, as the JAX package's flattening does (so
    ``sample_per_part`` above 1 raises there and here).  ``trans`` is an
    attribute, as in the JAX package: a tensor, or an NDArray through
    ``nd``."""
    ps = int(pooled_size)
    gs = int(group_size)
    od = int(output_dim)
    pt = int(part_size) if int(part_size) > 0 else ps
    sp = int(sample_per_part)
    n, c, h, w = data.shape
    r = rois.to(torch.float32)
    nr = r.shape[0]
    dev = data.device
    img = _take_batch(data, r[:, 0])
    x1 = torch.round(r[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(r[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(r[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(r[:, 4] + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp_min(0.1)
    rh = (y2 - y1).clamp_min(0.1)
    bh, bw = rh / ps, rw / ps
    iy = torch.arange(ps, dtype=torch.float32, device=dev)
    ix = torch.arange(ps, dtype=torch.float32, device=dev)
    if no_trans or trans is None:
        dy = torch.zeros(nr, ps, ps, device=dev)
        dx = torch.zeros(nr, ps, ps, device=dev)
    else:
        tr = (trans if isinstance(trans, torch.Tensor) else trans.data()) \
            .to(device=dev, dtype=torch.float32)
        pi = torch.div(iy * pt, ps, rounding_mode="floor").to(torch.int64)
        pj = torch.div(ix * pt, ps, rounding_mode="floor").to(torch.int64)
        dy = tr[:, 0][:, pi[:, None], pj[None, :]] * trans_std \
            * rh[:, None, None]
        dx = tr[:, 1][:, pi[:, None], pj[None, :]] * trans_std \
            * rw[:, None, None]
    ss = (torch.arange(sp, dtype=torch.float32, device=dev) + 0.5) / sp
    ys = (y1[:, None, None, None, None]
          + iy[None, :, None, None, None] * bh[:, None, None, None, None]
          + dy[:, :, :, None, None]
          + ss[None, None, None, :, None] * bh[:, None, None, None, None])
    xs = (x1[:, None, None, None, None]
          + ix[None, None, :, None, None] * bw[:, None, None, None, None]
          + dx[:, :, :, None, None]
          + ss[None, None, None, None, :] * bw[:, None, None, None, None])
    pts = _roi_align_points(img, ys.reshape(nr, -1), xs.reshape(nr, -1))
    avg = pts.reshape(nr, c, ps, ps, sp * sp).mean(dim=4)
    out = _pick_ps(avg, od, gs, ps)
    return out.to(data.dtype), torch.zeros_like(out)


def _zero_pad_sample(img, ys, xs):
    """Bilinear samples of (N, C, H, W) at float coords (N, P) -> (N, C,
    P); a corner outside the map contributes 0 (im2col's zero pad)."""
    h, w = img.shape[2], img.shape[3]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]

    def g(yi, xi):
        ok = ((yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)).to(
            img.dtype)[:, None]
        return _gather_points(img, yi, xi) * ok

    return (g(y0, x0) * ((1 - wy) * (1 - wx))
            + g(y0, x0 + 1) * ((1 - wy) * wx)
            + g(y0 + 1, x0) * (wy * (1 - wx))
            + g(y0 + 1, x0 + 1) * (wy * wx))


@register("_contrib_DeformableConvolution",
          inputs=("data", "offset", "weight", "bias"))
def _deformable_convolution(data, offset, weight, bias=None, kernel=(1, 1),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=1, num_group=1,
                            num_deformable_group=1, workspace=1024,
                            no_bias=False, layout=None):
    """Deformable convolution v1 (reference:
    contrib/deformable_convolution.cc): per-tap offset fields shift the
    sampling grid; the sampled columns contract with the weight."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = (int(stride[0]), int(stride[1])) if stride else (1, 1)
    dh, dw = (int(dilate[0]), int(dilate[1])) if dilate else (1, 1)
    ph, pw = (int(pad[0]), int(pad[1])) if pad else (0, 0)
    n, c, h, w = data.shape
    ndg = int(num_deformable_group)
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = data.device
    oy = torch.arange(oh, dtype=torch.float32, device=dev) * sh - ph
    ox = torch.arange(ow, dtype=torch.float32, device=dev) * sw - pw
    cpg = c // ndg
    cols = []
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            taps = []
            for g in range(ndg):
                off_y = offset[:, (g * kh * kw + t) * 2]
                off_x = offset[:, (g * kh * kw + t) * 2 + 1]
                ys = oy[None, :, None] + i * dh + off_y
                xs = ox[None, None, :] + j * dw + off_x
                img_g = data[:, g * cpg:(g + 1) * cpg]
                taps.append(_zero_pad_sample(
                    img_g, ys.reshape(n, -1), xs.reshape(n, -1))
                    .reshape(n, cpg, oh, ow))
            cols.append(torch.cat(taps, dim=1))
    col = torch.stack(cols, dim=2)                  # (N, C, kh*kw, oh, ow)
    f = int(num_filter)
    ng = int(num_group)
    col = col.reshape(n, ng, c // ng, kh * kw, oh, ow)
    wgt = weight.reshape(ng, f // ng, c // ng, kh * kw)
    out = torch.einsum("ngckhw,gfck->ngfhw", col, wgt).reshape(n, f, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# ----------------------------------------------------------------------------
# SSD MultiBox ops
# ----------------------------------------------------------------------------


@register("_contrib_MultiBoxPrior")
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors of an NCHW feature map: (1, H*W*A, 4) corner boxes,
    rows ordered (h, w, anchor).  Built from aranges and constants on the
    data's device (nothing copied from the host), so it captures."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps and steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps and steps[1] > 0 else 1.0 / w
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
    half = []
    r0 = ratios[0] ** 0.5 if ratios else 1.0
    for s in sizes:
        half.append((s * h / w * r0 / 2, s / r0 / 2))
    for r in ratios[1:]:
        rq = r ** 0.5
        half.append((sizes[0] * h / w * rq / 2, sizes[0] / rq / 2))
    boxes = torch.stack([torch.stack(
        [cxx - _f32(hw), cyy - _f32(hh), cxx + _f32(hw), cyy + _f32(hh)],
        dim=-1) for hw, hh in half], dim=2)                 # (h, w, A, 4)
    out = boxes.reshape(1, -1, 4)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


def _corner_to_center(b):
    aw = b[..., 2] - b[..., 0]
    ah = b[..., 3] - b[..., 1]
    ax = (b[..., 0] + b[..., 2]) / 2
    ay = (b[..., 1] + b[..., 3]) / 2
    return ax, ay, aw, ah


@register("_contrib_MultiBoxTarget")
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD target assignment (reference: contrib/multibox_target.cc):
    ``(loc_target (B, A*4), loc_mask (B, A*4), cls_target (B, A))``.
    Each ground truth greedily claims its best remaining anchor (G rounds
    of a first-maximum argmax over the flat (A, G) matrix, guarded by a
    ``where``), then unmatched anchors take any ground truth above
    ``overlap_threshold``; with ``negative_mining_ratio > 0`` the hardest
    negatives are kept, ranked by a stable sort.  No host read: it
    captures."""
    anchors = anchor.reshape(-1, 4).to(torch.float32)
    lab = label.to(torch.float32)
    pred = cls_pred.to(torch.float32)
    a = anchors.shape[0]
    bsz, g = lab.shape[0], lab.shape[1]
    dev = anchors.device
    vx, vy, vw, vh = (float(v) for v in variances)
    valid = lab[:, :, 0] >= 0                                # (B, G)
    gt = lab[:, :, 1:5]
    ious = _nms.iou(anchors[None, :, None, :], gt[:, None, :, :])
    ious = torch.where(valid[:, None, :], ious, torch.zeros_like(ious))
    arange_a = torch.arange(a, device=dev)
    arange_g = torch.arange(g, device=dev)
    match = torch.full((bsz, a), -1, dtype=torch.int64, device=dev)
    iou_m = ious
    for _ in range(g):
        flat = torch.argmax(iou_m.reshape(bsz, -1), dim=1)   # (B,)
        ai = torch.div(flat, g, rounding_mode="floor")
        gi = flat % g
        ok = iou_m.reshape(bsz, -1).gather(1, flat[:, None])[:, 0] > 1e-12
        hit_a = arange_a[None, :] == ai[:, None]             # (B, A)
        match = torch.where(ok[:, None] & hit_a, gi[:, None], match)
        hit = (hit_a[:, :, None]
               | (arange_g[None, None, :] == gi[:, None, None]))
        iou_m = torch.where(ok[:, None, None] & hit,
                            torch.full_like(iou_m, -1.0), iou_m)
    best_iou = ious.amax(dim=2)
    best_gt = torch.argmax(ious, dim=2)
    match = torch.where((match < 0) & (best_iou > overlap_threshold),
                        best_gt, match)
    matched = match >= 0
    mi = match.clamp(0, max(g - 1, 0))
    mgt = torch.gather(gt, 1, mi[:, :, None].expand(bsz, a, 4))
    ax, ay, aw, ah = _corner_to_center(anchors)
    gx, gy, gw, gh = _corner_to_center(mgt)
    loc = torch.stack([(gx - ax) / aw / vx, (gy - ay) / ah / vy,
                       torch.log((gw / aw).clamp_min(1e-12)) / vw,
                       torch.log((gh / ah).clamp_min(1e-12)) / vh], dim=2)
    loc = torch.where(matched[:, :, None], loc, torch.zeros_like(loc))
    mask = matched[:, :, None].to(torch.float32).expand(bsz, a, 4)
    cls_t = torch.where(matched, torch.gather(lab[:, :, 0], 1, mi) + 1.0,
                        torch.zeros_like(loc[:, :, 0]))
    if negative_mining_ratio > 0:
        max_np = pred[:, 1:, :].amax(dim=1)                 # (B, A)
        neg_ok = (~matched) & (max_np > negative_mining_thresh)
        n_pos = matched.sum(dim=1, keepdim=True)
        k = (n_pos * negative_mining_ratio).clamp_min(
            float(minimum_negative_samples))
        score = torch.where(neg_ok, max_np, torch.full_like(max_np, -1.0))
        order = torch.sort(-score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, arange_a[None, :].expand(bsz, a).contiguous())
        keep_neg = neg_ok & (rank < k)
        cls_t = torch.where(
            matched, cls_t,
            torch.where(keep_neg, torch.zeros_like(cls_t),
                        torch.full_like(cls_t, float(ignore_label))))
    return loc.reshape(bsz, -1), mask.reshape(bsz, -1), cls_t


def _decode_dets(cls_prob, loc_pred, anchor, clip, threshold, variances):
    """(B, A, 6) rows [class, score, x0, y0, x1, y1] before NMS."""
    anchors = anchor.reshape(-1, 4)
    vx, vy, vw, vh = (float(v) for v in variances)
    ax, ay, aw, ah = _corner_to_center(anchors)
    lp = loc_pred.reshape(loc_pred.shape[0], -1, 4)
    score = cls_prob[:, 1:, :].amax(dim=1)
    cid = torch.argmax(cls_prob[:, 1:, :], dim=1).to(torch.float32)
    cid = torch.where(score < threshold, torch.full_like(cid, -1.0), cid)
    ox = lp[..., 0] * vx * aw + ax
    oy = lp[..., 1] * vy * ah + ay
    ow = torch.exp(lp[..., 2] * vw) * aw / 2
    oh = torch.exp(lp[..., 3] * vh) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=2)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return torch.cat([cid[..., None], score[..., None], boxes], dim=2)


@register("_contrib_MultiBoxDetection")
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode SSD predictions and keep them with ``_contrib_box_nms``
    (O4): (B, A, 6) rows [class, score, x0, y0, x1, y1], sorted by
    score, a suppressed row all -1."""
    from .contrib import _box_nms

    dets = _decode_dets(cls_prob, loc_pred, anchor, clip, threshold,
                        variances)
    out, _ = _box_nms(dets, overlap_thresh=nms_threshold, valid_thresh=0.0,
                      topk=nms_topk, coord_start=2, score_index=1,
                      id_index=0, force_suppress=force_suppress)
    return out


@register("_contrib_box_decode")
def _box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
                clip=-1.0, format="corner"):
    a = anchors.reshape(-1, 4)
    if format == "corner":
        ax, ay, aw, ah = _corner_to_center(a)
    else:
        ax, ay, aw, ah = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    ox = data[..., 0] * std0 * aw + ax
    oy = data[..., 1] * std1 * ah + ay
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = dw.clamp_max(clip)
        dh = dh.clamp_max(clip)
    ow = torch.exp(dw) * aw / 2
    oh = torch.exp(dh) * ah / 2
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


@register("_contrib_box_encode")
def _box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """Matched ground truths as regression targets (gluon-cv parity):
    ``(targets, masks)``, each (B, N, 4)."""
    m = means if means is not None else (0., 0., 0., 0.)
    s = stds if stds is not None else (0.1, 0.1, 0.2, 0.2)
    anc = anchors.to(torch.float32)
    ref = refs.to(torch.float32)
    g = ref.shape[1]
    mi = matches.to(torch.float32).to(torch.int64).clamp(0, g - 1)
    mref = torch.gather(ref, 1, mi[..., None].expand(-1, -1, 4))
    ax, ay, aw, ah = _corner_to_center(anc)
    gx, gy, gw, gh = _corner_to_center(mref)
    parts = [(gx - ax) / aw, (gy - ay) / ah,
             torch.log((gw / aw).clamp_min(1e-12)),
             torch.log((gh / ah).clamp_min(1e-12))]
    t = torch.stack([(p - _f32(mk)) / _f32(sk)
                     for p, mk, sk in zip(parts, m, s)], dim=-1)
    mask = (samples.to(torch.float32) > 0.5)[..., None]
    return (torch.where(mask, t, torch.zeros_like(t)),
            mask.to(t.dtype).expand(t.shape))


@register("_contrib_bipartite_matching")
def _bipartite_matching(data, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy bipartite matching on a (..., N, M) score matrix (reference:
    bounding_box-inl.h BipartiteMatchingForward): ``(row matches (...,
    N), column matches (..., M))``, -1 where unmatched."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:])).to(torch.float32)
    b, n, m = flat.shape
    dev = flat.device
    sign = 1.0 if not is_ascend else -1.0
    sm = flat * sign
    row_m = torch.full((b, n), -1.0, device=dev)
    col_m = torch.full((b, m), -1.0, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    for _ in range(min(n, m)):
        fi = torch.argmax(sm.reshape(b, -1), dim=1)
        ri = torch.div(fi, m, rounding_mode="floor")
        ci = fi % m
        best = sm.reshape(b, -1).gather(1, fi[:, None])[:, 0]
        raw = best * sign
        ok = (raw > threshold) if not is_ascend else (raw < threshold)
        ok = ok & (best > _NEG / 2)
        if topk > 0:
            ok = ok & (count < topk)
        hit_r = rows[None, :] == ri[:, None]
        hit_c = cols[None, :] == ci[:, None]
        row_m = torch.where(ok[:, None] & hit_r, ci[:, None].to(torch.float32),
                            row_m)
        col_m = torch.where(ok[:, None] & hit_c, ri[:, None].to(torch.float32),
                            col_m)
        sm = torch.where(ok[:, None, None]
                         & (hit_r[:, :, None] | hit_c[:, None, :]), neg, sm)
        count = count + ok.to(torch.int32)
    return row_m.reshape(shape[:-1]), col_m.reshape(shape[:-2] + (m,))


# ----------------------------------------------------------------------------
# RPN proposals (reference: contrib/proposal.cc, multi_proposal.cc)
# ----------------------------------------------------------------------------


def _gen_base_anchors(scales, ratios, base_size):
    """(A, 4) f32 base anchors, in the JAX package's f32 arithmetic."""
    f = np.float32
    base = np.asarray([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + f(1)
    h = base[3] - base[1] + f(1)
    cx = base[0] + f(0.5) * (w - f(1))
    cy = base[1] + f(0.5) * (h - f(1))
    out = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / f(r)))
        hs = np.round(ws * f(r))
        for s in scales:
            wss, hss = ws * f(s), hs * f(s)
            out.append([cx - f(0.5) * (wss - f(1)), cy - f(0.5) * (hss - f(1)),
                        cx + f(0.5) * (wss - f(1)), cy + f(0.5) * (hss - f(1))])
    return np.asarray(out, np.float32)


def _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride):
    dev = cls_prob.device
    stride = float(feature_stride)
    base = torch.from_numpy(_gen_base_anchors(
        tuple(scales), tuple(ratios), stride)).to(dev)
    a = base.shape[0]
    fg = cls_prob[:, a:, :, :]
    n, _, fh, fw = fg.shape
    pre_n = min(int(rpn_pre_nms_top_n), a * fh * fw)
    post_n = int(rpn_post_nms_top_n)
    sy = torch.arange(fh, dtype=torch.float32, device=dev) * stride
    sx = torch.arange(fw, dtype=torch.float32, device=dev) * stride
    shift = torch.stack(torch.meshgrid(sx, sy, indexing="xy"), dim=-1)
    # anchor-major flat order matches the (A, fh, fw) score layout
    anchors = (base[:, None, None, :]
               + torch.cat([shift, shift], -1)[None]).reshape(-1, 4)
    d = bbox_pred.reshape(n, a, 4, fh, fw).permute(0, 1, 3, 4, 2) \
        .reshape(n, -1, 4)
    s = fg.reshape(n, -1)
    ax, ay, aw, ah = _corner_to_center(anchors)
    aw, ah = aw + 1, ah + 1
    cx = d[..., 0] * aw + ax
    cy = d[..., 1] * ah + ay
    pw = torch.exp(d[..., 2].clamp(-10, 10)) * aw
    ph = torch.exp(d[..., 3].clamp(-10, 10)) * ah
    boxes = torch.stack([cx - 0.5 * (pw - 1), cy - 0.5 * (ph - 1),
                         cx + 0.5 * (pw - 1), cy + 0.5 * (ph - 1)], dim=2)
    info = im_info.to(boxes.dtype)
    wmax = (info[:, 1] - 1)[:, None]
    hmax = (info[:, 0] - 1)[:, None]
    zero = torch.zeros_like(wmax)
    boxes = torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), wmax),
        torch.minimum(torch.maximum(boxes[..., 1], zero), hmax),
        torch.minimum(torch.maximum(boxes[..., 2], zero), wmax),
        torch.minimum(torch.maximum(boxes[..., 3], zero), hmax)], dim=2)
    ms = (float(rpn_min_size) * info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms)
            & (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    s = torch.where(keep, s, torch.full_like(s, -1.0))
    order = torch.sort(-s, dim=1, stable=True).indices[:, :pre_n]
    boxes_k = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    s_k = torch.gather(s, 1, order)
    keep_m = _nms.nms_keep(boxes_k.detach().contiguous(), s_k > -1.0,
                           threshold)
    sc = torch.where(keep_m, s_k, torch.full_like(s_k, -1.0))
    order2 = torch.sort(-sc, dim=1, stable=True).indices[:, :post_n]
    out_b = torch.gather(boxes_k, 1, order2[..., None].expand(-1, -1, 4))
    out_s = torch.gather(sc, 1, order2).clamp_min(0.0)
    bidx = torch.arange(n, dtype=torch.float32, device=dev) \
        .repeat_interleave(post_n)
    rois = torch.cat([bidx[:, None], out_b.reshape(-1, 4)], dim=1)
    return rois, out_s.reshape(-1, 1)


@register("_contrib_Proposal")
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals: ``(rois (N*post_n, 5), scores (N*post_n, 1))``; the
    NMS over the top ``rpn_pre_nms_top_n`` is O4."""
    return _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                          rpn_post_nms_top_n, threshold, rpn_min_size,
                          scales, ratios, feature_stride)


@register("_contrib_MultiProposal")
def _multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                    rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                    scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                    feature_stride=16, output_score=False, iou_loss=False):
    return _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                          rpn_post_nms_top_n, threshold, rpn_min_size,
                          scales, ratios, feature_stride)


@register("_contrib_mrcnn_mask_target")
def _mrcnn_mask_target(rois, gt_masks, matches, cls_targets,
                       num_rois=0, num_classes=1, mask_size=(14, 14),
                       sample_ratio=2, aligned=False):
    """Mask R-CNN targets (reference: contrib/mrcnn_mask_target.cu): each
    ROI's matched mask cropped and resized by bilinear sampling into its
    class's slot; ``(targets, weights)``, each (B, R, classes, h, w)."""
    ms_h, ms_w = (int(mask_size[0]), int(mask_size[1])) \
        if isinstance(mask_size, (tuple, list)) else (int(mask_size),) * 2
    nc = int(num_classes)
    r = rois.to(torch.float32)
    bsz, nr = r.shape[0], r.shape[1]
    g = gt_masks.shape[1]
    dev = r.device
    mi = matches.to(torch.float32).to(torch.int64).clamp(0, g - 1)
    masks = torch.gather(gt_masks.to(torch.float32), 1,
                         mi[:, :, None, None].expand(
                             bsz, nr, gt_masks.shape[2], gt_masks.shape[3]))
    x1, y1, x2, y2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    bh = (y2 - y1).clamp_min(1.0) / ms_h
    bw = (x2 - x1).clamp_min(1.0) / ms_w
    iy = torch.arange(ms_h, dtype=torch.float32, device=dev)
    ix = torch.arange(ms_w, dtype=torch.float32, device=dev)
    ys = y1[..., None] + (iy + 0.5) * bh[..., None]          # (B, R, h)
    xs = x1[..., None] + (ix + 0.5) * bw[..., None]          # (B, R, w)
    yy = ys[..., :, None].expand(bsz, nr, ms_h, ms_w)
    xx = xs[..., None, :].expand(bsz, nr, ms_h, ms_w)
    m = _roi_align_points(masks.reshape(bsz * nr, 1, *masks.shape[2:]),
                          yy.reshape(bsz * nr, -1), xx.reshape(bsz * nr, -1))
    m = m.reshape(bsz, nr, ms_h, ms_w)
    cls_i = cls_targets.to(torch.float32).to(torch.int64)
    slot = torch.arange(nc, device=dev)[None, None, :] \
        == cls_i.clamp(0, nc - 1)[..., None]                 # (B, R, nc)
    tgt = torch.where(slot[..., None, None], m[:, :, None],
                      torch.zeros((), device=dev))
    wgt = torch.where(slot & (cls_i > 0)[..., None],
                      torch.ones((), device=dev), torch.zeros((), device=dev))
    return tgt, wgt[..., None, None].expand(bsz, nr, nc, ms_h, ms_w) \
        .contiguous()


# ----------------------------------------------------------------------------
# SyncBatchNorm: BatchNorm over the channel axis on one device (a sharded
# batch is slice S8)
# ----------------------------------------------------------------------------


@register("_contrib_SyncBatchNorm", needs_mode=True,
          inputs=("data", "gamma", "beta", "moving_mean", "moving_var"))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key="", _mode="train"):
    return _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                       momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats,
                       output_mean_var=output_mean_var, axis=1, _mode=_mode)


alias("_contrib_SparseEmbedding", "Embedding")


@register("_contrib_RROIAlign")
def _rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
                sampling_ratio=-1):
    """Rotated ROIAlign (reference: contrib/rroi_align.cc): rois are
    (batch, cx, cy, w, h, angle in degrees); the sampling grid turns by
    the angle."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    sr = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    r = rois.to(torch.float32)
    nr = r.shape[0]
    dev = data.device
    img = _take_batch(data, r[:, 0])
    cx = r[:, 1] * spatial_scale
    cy = r[:, 2] * spatial_scale
    rw = (r[:, 3] * spatial_scale).clamp_min(1.0)
    rh = (r[:, 4] * spatial_scale).clamp_min(1.0)
    theta = r[:, 5] * math.pi / 180.0
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    ss = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    ly = ((iy[:, None] + ss[None, :]) / ph - 0.5)[None] \
        * rh[:, None, None]                                  # (R, ph, sr)
    lx = ((ix[:, None] + ss[None, :]) / pw - 0.5)[None] \
        * rw[:, None, None]                                  # (R, pw, sr)
    lyy = ly[:, :, None, :, None].expand(nr, ph, pw, sr, sr)
    lxx = lx[:, None, :, None, :].expand(nr, ph, pw, sr, sr)
    cosn = torch.cos(theta)[:, None, None, None, None]
    sinn = torch.sin(theta)[:, None, None, None, None]
    xs = cx[:, None, None, None, None] + lxx * cosn - lyy * sinn
    ys = cy[:, None, None, None, None] + lxx * sinn + lyy * cosn
    pts = _roi_align_points(img, ys.reshape(nr, -1), xs.reshape(nr, -1))
    return pts.reshape(nr, img.shape[1], ph, pw, sr * sr).mean(dim=4) \
        .to(data.dtype)
