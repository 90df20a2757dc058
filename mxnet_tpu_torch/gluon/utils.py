"""Gluon's utilities on one device (the port's counterpart of
``mxnet_tpu/gluon/utils.py``): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1``, ``download``, ``HookHandle`` and
``shape_is_known``.

``clip_global_norm`` scales NDArrays in place by
``min(max_norm / (norm + 1e-8), 1)``, the JAX package's rule, with the
global norm from one O3 read (``ops.optimizer_ops.multi_sum_sq``: each
array's sum of squares, deterministic) and the scaling as one
multi-tensor multiply per dtype.  ``download`` reads nothing from the
network: it returns the path of a file that is there (with the right
sha1, when one is given) and raises ``MXNetError`` otherwise.
``split_and_load`` takes a list of contexts; a mesh is slice S8.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import os
import warnings
import weakref

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` into ``num_slice`` slices along ``batch_axis``; a
    list even when ``num_slice == 1``.  Without ``even_split`` the
    leading slices get one extra row (parity: gluon.utils.split_data)."""
    from ..ndarray.ndarray import NDArray, array

    if not isinstance(data, NDArray):
        data = array(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    n_each, extras = divmod(size, num_slice)
    sizes = extras * [n_each + 1] + (num_slice - extras) * [n_each]
    points = _np.cumsum([0] + sizes)
    raw = data._data
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * raw.ndim
        idx[batch_axis] = slice(int(points[i]), int(points[i + 1]))
        slices.append(NDArray._wrap(raw[tuple(idx)].clone(), data.context))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and load the slices onto the
    contexts of ``ctx_list``: a list of NDArrays (parity:
    gluon.utils.split_and_load).  One device: the port runs on one card,
    so a list of one context gives the whole batch there."""
    from ..ndarray.ndarray import NDArray, array

    if not isinstance(ctx_list, (list, tuple)):
        raise MXNetError("split_and_load(ctx_list=%r): a mesh is sharded "
                         "training, slice S8 of the port (ROADMAP.md)"
                         % (ctx_list,))
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def global_norm_scale(tensors, max_norm):
    """``(scale, total_norm)`` of the global-norm clip over ``tensors``:
    the norm from O3's per-tensor sums of squares, the scale
    ``min(max_norm / (norm + 1e-8), 1)``; both f32 0-d tensors on the
    tensors' device, read without a sync."""
    from ..ops import optimizer_ops as _ops

    sums, _ = _ops.multi_sum_sq(tensors)
    total = sums.sum().sqrt()
    scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
    return scale, total


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` (NDArrays, in place) so their joint L2 norm is
    at most ``max_norm``; return the norm before the clip: a float when
    ``check_isfinite`` (which syncs, and warns on a non-finite norm, as
    the JAX package does), else a shape-(1,) NDArray."""
    from ..ndarray.ndarray import NDArray

    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    if not all(isinstance(a, NDArray) for a in arrays):
        raise TypeError("clip_global_norm expects a list of NDArray "
                        "(scaled in place)")
    raws = [a._data for a in arrays]
    scale, total = global_norm_scale(raws, max_norm)
    groups = collections.defaultdict(list)
    for r in raws:
        groups[r.dtype].append(r)
    with torch.no_grad():
        for dt, group in groups.items():
            torch._foreach_mul_(group, scale.to(dt))
    for a in arrays:
        a._var.on_write()
    if check_isfinite:
        tn = float(total)
        if not _np.isfinite(tn):
            warnings.warn(UserWarning("nan or inf is detected. "
                                      "Clipping results will be undefined."),
                          stacklevel=2)
        return tn
    return NDArray._wrap(total.reshape(1), arrays[0].context)


def check_sha1(filename, sha1_hash):
    """True iff the sha1 of ``filename``'s content equals ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The local file ``url`` would be downloaded to (parity:
    gluon.utils.download's naming): returned when it exists (and has
    ``sha1_hash``, when given); the port fetches nothing, so a missing
    or mismatched file, or ``overwrite=True``, raises ``MXNetError``."""
    del retries, verify_ssl
    if path is None:
        fname = url.split("/")[-1]
        if not fname:
            raise MXNetError("cannot construct a file name from %r; set "
                             "path" % url)
    else:
        path = os.path.expanduser(path)
        fname = os.path.join(path, url.split("/")[-1]) \
            if os.path.isdir(path) else path
    if not overwrite and os.path.exists(fname) and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(
        "download(%s): the port reads local files only and fetches "
        "nothing; place the file at %s%s" % (
            url, fname, " with sha1 %s" % sha1_hash if sha1_hash else ""))


class HookHandle:
    """A removable handle for a registered hook (parity:
    gluon.utils.HookHandle)."""

    _next_id = itertools.count()

    def __init__(self):
        self._hooks_dict_ref = None
        self._id = None

    def attach(self, hooks_dict, hook):
        if self._hooks_dict_ref:
            raise MXNetError("The same handle cannot be attached twice.")
        self._id = next(HookHandle._next_id)
        hooks_dict[self._id] = hook
        self._hooks_dict_ref = weakref.ref(hooks_dict)

    def detach(self):
        hooks_dict = self._hooks_dict_ref()
        if hooks_dict is not None and self._id in hooks_dict:
            del hooks_dict[self._id]

    def __getstate__(self):
        return (self._hooks_dict_ref(), self._id)

    def __setstate__(self, state):
        if state[0] is None:
            self._hooks_dict_ref = weakref.ref(collections.OrderedDict())
        else:
            self._hooks_dict_ref = weakref.ref(state[0])
        self._id = state[1]

    def __enter__(self):
        return self

    def __exit__(self, ptype, value, trace):
        self.detach()


def shape_is_known(shape):
    """Whether ``shape`` is fully known (no 0, -1 or None dimension)."""
    if shape is None:
        return False
    unknown = (0, -1, None)
    if len(shape) == 0:
        return True
    return all(dim not in unknown for dim in shape)
