"""INT8 quantization (the port's counterpart of
``mxnet_tpu/contrib/quantization.py``; parity:
python/mxnet/contrib/quantization.py).

``quantize_net_v2`` walks a Gluon network, calibrates the input range of
each ``nn.Dense`` and ``nn.Conv2D`` child over a dataset, by its
largest magnitude (``"naive"``) or by the KL-divergence threshold
(``"entropy"``, ``calibrate.cc``), and swaps those children, in place,
for ``QuantizedDense`` and ``QuantizedConv2D``.  Their products run on
the card's hand-written int8 kernels, O5 and O6 (``ops/int8_ops.py``):
int8 x int8 with int32 sums, then the dequantize and bias in the kernel's
epilogue, each operation rounded as the JAX package's layers round it:

- a weight is quantized per tensor, ``round(w * f32(127 / |w|max))``
  (half to even), clipped to [-127, 127], on the host with numpy;
- an activation is ``clip(round(x * f32(127 / threshold)), -127, 127)``
  in the input's dtype (``int8_ops.quantize_int8``, plain torch);
- the output is ``f32(acc) / f32(x_scale * w_scale) + bias`` (the
  denominator multiplied in double, as Python multiplies the two
  scales), then the layer's own activation.

A ``QuantizedConv2D`` takes the layer's layout: on the card the
channels-last tensors the model zoo's ``Conv2D`` makes, with its OIHW
weight turned into the OHWI int8 that O6 reads.  Unlike the JAX
package's layer it applies the layer's ``dilate`` (ROADMAP.md R11).  The
int8 weights and the bias are buffers, not ``Parameter``s, so the
quantized net's ``collect_params()`` has the JAX package's keys (those
of the layers that were not swapped).

Calibration sees every quantized layer's input also when the net is
hybridized and holds captured graphs: it observes through forward
pre-hooks with every ``HybridBlock`` of the tree disarmed, so each call
runs eagerly, and after the swap it drops the tree's graphs, so a
hybridized net's next call captures the int8 path.  The JAX package's
spy never runs under a replayed executable, and its net keeps its f32
outputs (ROADMAP.md R10); MXNet's ``quantize_net_v2`` returns a new
block and has no such problem.

Naive calibration keeps a running largest magnitude a layer on the
device (the threshold is the same bit for bit); entropy calibration
keeps each batch's magnitudes on the device and takes their histogram
there, over numpy's own bin edges, then runs the KL search of
``_get_optimal_threshold`` on the host.  ``quantize_graph`` and
``quantize_model`` take Symbols, which come with slice S9.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import graph_cache as _graph_cache
from ..base import MXNetError
from ..gluon import nn as _nn
from ..gluon.block import Block, HybridBlock, _clear_caches
from ..ndarray.ndarray import NDArray
from ..ops import int8_ops as _int8
from ..ops.nn import channel_last

# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _kl_divergence(p, q):
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] /
                                         np.maximum(q[mask], 1e-12))))


def _expand_quantized(sliced, num_quantized_bins):
    """Q of ``_get_optimal_threshold``: ``sliced`` (at least
    ``num_quantized_bins`` bins) cut into ``num_quantized_bins`` chunks,
    each nonzero bin replaced by its chunk's mean over the nonzero bins.
    The bins hold counts, so each chunk's sum is exact in any order and
    the chunks are summed at once (``reduceat``), with the bounds and the
    one division per chunk the JAX package's loop takes."""
    size = sliced.size
    lo = (np.arange(num_quantized_bins)
          * (size / num_quantized_bins)).astype(np.int64)
    sums = np.add.reduceat(sliced, lo)
    nz = np.add.reduceat((sliced > 0).astype(np.int64), lo)
    mean = np.zeros_like(sums)
    np.divide(sums, nz, out=mean, where=nz > 0)
    return np.where(sliced > 0, np.repeat(mean, np.diff(np.append(lo, size))),
                    0)


def _threshold_from_hist(hist, edges, max_val, num_bins=1001,
                         num_quantized_bins=255):
    """The KL search of ``_get_optimal_threshold`` over a histogram of
    ``num_bins`` bins of [0, ``max_val``] and its edges."""
    best_kl, best_t = None, max_val
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 64)):
        threshold = edges[i] if i < len(edges) else max_val
        sliced = hist[:i].astype(np.float64)
        if sliced.size == 0:
            continue
        # P: clipped distribution — outlier mass folds into the last bin;
        # Q: the QUANTIZED version of the unclipped slice (reference
        # calibrate.cc / TensorRT formulation)
        p = sliced.copy()
        p[-1] += hist[i:].sum()
        q = _expand_quantized(sliced, num_quantized_bins)
        kl = _kl_divergence(p, q)
        if best_kl is None or kl < best_kl:
            best_kl, best_t = kl, threshold
    return max(best_t, 1e-8)


def _get_optimal_threshold(samples, num_bins=1001, num_quantized_bins=255):
    """KL-optimal |threshold| for int8 (parity: calibrate.cc
    GetOptimalThreshold — minimize KL(P||Q) over truncation points)."""
    arr = np.abs(np.concatenate([np.asarray(s).ravel() for s in samples]))
    max_val = float(arr.max()) if arr.size else 1.0
    if max_val == 0.0:
        return 1e-8
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, max_val))
    return _threshold_from_hist(hist, edges, max_val, num_bins,
                                num_quantized_bins)


def _device_histogram(parts, num_bins, max_val):
    """``np.histogram(concat(parts), num_bins, (0, max_val))`` of the f32
    magnitudes ``parts`` (1-d tensors), counted where they lie: numpy's
    edges (an f32 ``linspace``), each value in the bin ``i`` with
    ``edges[i] <= v < edges[i + 1]``, the last bin closed."""
    edges = np.histogram(np.zeros(0, np.float32), bins=num_bins,
                         range=(0, max_val))[1]
    hist = np.zeros(num_bins, np.int64)
    for p in parts:
        e = torch.from_numpy(edges).to(p.device, p.dtype)
        idx = (torch.bucketize(p, e, right=True) - 1).clamp_(0, num_bins - 1)
        hist += torch.bincount(idx, minlength=num_bins).cpu().numpy()
    return hist, edges


def _as_tensor(arr):
    if isinstance(arr, NDArray):
        return arr._data
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.asarray(arr))


class _Calibrator:
    """Collect per-layer input ranges over calibration batches: a running
    largest magnitude (naive) or every batch's magnitudes (entropy), kept
    on the inputs' device."""

    def __init__(self, mode="naive"):
        if mode not in ("naive", "entropy"):
            raise MXNetError("calib_mode must be naive or entropy")
        self.mode = mode
        self.samples = {}

    def observe(self, name, arr):
        t = _as_tensor(arr).detach()
        if self.mode == "naive":
            if t.numel():
                m = t.abs().max()
                prev = self.samples.get(name)
                self.samples[name] = m if prev is None \
                    else torch.maximum(prev, m)
            return
        self.samples.setdefault(name, []).append(
            t.abs().reshape(-1).to(torch.float32))

    def threshold(self, name):
        samples = self.samples.get(name)
        if samples is None:
            return 1.0
        if self.mode == "naive":
            return float(samples) or 1e-8
        parts = [p for p in samples if p.numel()]
        max_val = max(float(p.max()) for p in parts) if parts else 1.0
        if max_val == 0.0:
            return 1e-8
        hist, edges = _device_histogram(parts, 1001, max_val)
        return _threshold_from_hist(hist, edges, max_val)


# ---------------------------------------------------------------------------
# int8 blocks
# ---------------------------------------------------------------------------


def _quant_params(threshold):
    # symmetric int8: scale maps [-t, t] → [-127, 127]
    return 127.0 / float(threshold)


def _int8_weight(w):
    """``(int8 weight, w_scale)`` of an f32 weight tensor, on the host as
    the JAX package computes them."""
    w = w.detach().to("cpu", torch.float32).numpy()
    scale = _quant_params(np.abs(w).max() or 1e-8)
    return np.clip(np.round(w * scale), -127, 127).astype(np.int8), scale


class _Quantized(HybridBlock):
    """What the two int8 layers share: the scales, the int8 weight and
    the f32 bias as buffers, the layer's activation."""

    def __init__(self, layer, act_threshold, w_q, w_scale, prefix=None):
        super().__init__(prefix=prefix)
        dev = layer.weight.device
        self._threshold = float(act_threshold)
        self._w_scale = w_scale
        self._x_scale = _quant_params(act_threshold)
        # f32(x_scale * w_scale): the product in double, then one rounding
        self._denom = float(np.float32(self._x_scale * self._w_scale))
        self.register_buffer("_w_q", torch.from_numpy(w_q).to(dev))
        bias = getattr(layer, "bias", None)
        self.register_buffer("_bias", None if bias is None else
                             bias.detach().to(torch.float32).clone())
        self._act = getattr(layer, "act", None)

    def _finish(self, out):
        return out if self._act is None else self._act(out)


class QuantizedDense(_Quantized):
    """Dense with int8 weights/activations, int32 sums on O5."""

    def __init__(self, dense, act_threshold, prefix=None):
        w_q, w_scale = _int8_weight(dense.weight)
        super().__init__(dense, act_threshold, w_q, w_scale, prefix=prefix)
        self._flatten = getattr(dense, "_flatten", True)

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1) if self._flatten else x
        # O5 quantizes the f32 activation as it loads it
        out = _int8.int8_gemm(flat.reshape(-1, flat.shape[-1]), self._w_q,
                              bias=self._bias, denom=self._denom,
                              scale=self._x_scale)
        return self._finish(out.reshape(tuple(flat.shape[:-1])
                                        + (out.shape[-1],)))


class QuantizedConv2D(_Quantized):
    """Conv2D with int8 weights/activations, int32 sums on O6; stride,
    padding, dilation and groups are the layer's."""

    def __init__(self, conv, act_threshold, prefix=None):
        w_q, w_scale = _int8_weight(conv.weight)         # OIHW
        super().__init__(conv, act_threshold,
                         np.ascontiguousarray(w_q.transpose(0, 2, 3, 1)),
                         w_scale, prefix=prefix)          # OHWI
        kw = conv._kwargs
        self._stride = tuple(kw["stride"])
        self._pad = tuple(kw["pad"])
        self._dilate = tuple(kw["dilate"])
        self._groups = int(kw["num_group"])
        self._layout = kw["layout"]

    def forward(self, x):
        # O6 quantizes the f32 activation as it loads it, in its strides:
        # a channel-first input goes in as an NHWC view, not a copy
        last = channel_last(self._layout)
        out = _int8.int8_conv(x if last else x.permute(0, 2, 3, 1),
                              self._w_q, self._stride, self._pad,
                              self._dilate, self._groups, bias=self._bias,
                              denom=self._denom, scale=self._x_scale)
        return self._finish(out if last else out.permute(0, 3, 1, 2))


_QUANTIZABLE = {_nn.Dense: QuantizedDense, _nn.Conv2D: QuantizedConv2D}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _batch_input(batch, device):
    data = batch[0] if isinstance(batch, (list, tuple)) else batch
    if isinstance(data, (NDArray, torch.Tensor)):
        return data
    return torch.as_tensor(np.asarray(data)).to(device)


def quantize_net_v2(network, quantized_dtype="int8", calib_mode="naive",
                    calib_data=None, num_calib_batches=None,
                    exclude_layers=None, **kwargs):
    """Quantize a Gluon net in place (parity: quantization.py:826).

    Runs ``calib_data`` through the net in predict mode, observing each
    quantizable layer's input range (naive min/max or KL-entropy
    threshold), then replaces the ``nn.Dense``/``nn.Conv2D`` children
    (by exact type) that ``exclude_layers`` does not name (by path or
    name) with int8 blocks, and drops the tree's captured graphs.
    """
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError("quantized_dtype must be int8")
    if calib_data is None:
        raise MXNetError("calib_data is required")
    exclude = set(exclude_layers or ())

    targets = []

    def walk(block, path):
        for name, child in list(block._modules.items()):
            if not isinstance(child, Block):
                continue
            full = "%s.%s" % (path, name) if path else name
            if type(child) in _QUANTIZABLE and full not in exclude \
                    and child.name not in exclude:
                targets.append((block, name, full, child))
            else:
                walk(child, full)

    walk(network, "")
    if not targets:
        raise MXNetError("no quantizable layers found")

    calib = _Calibrator(calib_mode)
    hooks = [child.register_forward_pre_hook(
        (lambda full_name: lambda blk, args: calib.observe(
            full_name, args[0]))(full))
        for _, _, full, child in targets]
    # every call eager: a captured graph would replay past the hooks
    armed = [(b, b._active) for b in network.modules()
             if isinstance(b, HybridBlock)]
    device = next((p.device for p in network.parameters()), None)
    try:
        for b, _ in armed:
            b._active = False
        n = 0
        with autograd.predict_mode(), torch.no_grad():
            for batch in calib_data:
                network(_batch_input(batch, device))
                n += 1
                if num_calib_batches is not None and n >= num_calib_batches:
                    break
    finally:
        for b, active in armed:
            b._active = active
        for h in hooks:
            h.detach()

    for parent, name, full, child in targets:
        q = _QUANTIZABLE[type(child)](child, calib.threshold(full))
        if child._active:
            q.hybridize()
        setattr(parent, name, q)
    _graph_cache.tree_changed()
    _clear_caches(network)
    return network


def quantize_net(network, **kwargs):
    return quantize_net_v2(network, **kwargs)


def quantize_graph(sym, arg_params, aux_params, th_dict=None,
                   excluded_sym_names=None, quantized_dtype="int8",
                   **kwargs):
    """Parity: quantization.py:651; takes a Symbol, which comes with
    slice S9."""
    raise MXNetError("contrib.quantization.quantize_graph takes a Symbol: "
                     "mx.symbol is not ported yet (slice S9, ROADMAP.md); "
                     "quantize a Gluon net with quantize_net_v2")


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=None, calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", **kwargs):
    """Parity: quantization.py:463; takes a Symbol, which comes with
    slice S9."""
    raise MXNetError("contrib.quantization.quantize_model takes a Symbol: "
                     "mx.symbol is not ported yet (slice S9, ROADMAP.md); "
                     "quantize a Gluon net with quantize_net_v2")
