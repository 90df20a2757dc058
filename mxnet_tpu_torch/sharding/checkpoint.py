"""Mesh-shape-agnostic global-array checkpoints (format ``MXGC1``): the
port's own copy of ``mxnet_tpu/sharding/checkpoint.py`` (numpy only), so a
file that one package writes is read by the other.  The PartitionSpec
wire helpers are sharding, slice S8 of the port: an entry's spec is kept
as its wire form (None or a list), and bfloat16 payloads (which numpy
has no dtype for without ml_dtypes) are read as their uint16 bits with
the entry's ``"dtype"`` saying ``"bfloat16"``.

The elastic-training contract (docs/fault_tolerance.md): a checkpoint
written at dp=8 must restore onto ANY mesh whose axes divide the spec —
dp=6, dp=4, a single device.  That is only possible if the file stores
each array ONCE in its logical (global) shape together with its
PartitionSpec, never per-rank shards; restoring is then load +
``nd.shard()`` under whatever mesh is current.

Layout (all little-endian)::

    b"MXGC1\\n" | u64 index_len | index json | entry bytes (concatenated)

The index carries ``{"meta": {...}, "entries": [...]}`` where every
entry records ``name / dtype / shape / spec / offset / nbytes / crc32``
— offset relative to the data section.  Each entry's payload is
checksummed individually (zlib.crc32), so a bit flip or truncation
surfaces as an :class:`MXNetError` NAMING the damaged entry instead of
a raw unpickling backtrace; there is no pickle anywhere in the format,
so a hostile checkpoint can inject data at worst, not code.

Writers go through ``base.atomic_path`` — a preemption mid-write never
tears an existing checkpoint.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from ..base import MXNetError, atomic_path

_MAGIC = b"MXGC1\n"
FORMAT_VERSION = 1


_BF16 = "bfloat16"


def _host(arr):
    """``(bytes-ready array, dtype name)``: a torch bfloat16 tensor goes
    out as its uint16 bits under the name ``bfloat16``, as an ml_dtypes
    bfloat16 array does."""
    if hasattr(arr, "detach"):                  # a torch tensor
        t = arr.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    host = np.ascontiguousarray(np.asarray(arr))
    return host, str(host.dtype)


def is_global_checkpoint(fname):
    """True iff ``fname`` starts with the MXGC1 magic."""
    try:
        with open(fname, "rb") as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


def save_global(fname, entries, meta=None):
    """Write a global-array checkpoint.

    ``entries``: iterable of ``(name, array, spec)`` — ``array`` a torch
    tensor or any numpy-coercible host array in its LOGICAL (unsharded)
    shape, ``spec`` the wire form of a PartitionSpec (None for
    replicated; PartitionSpecs are S8).  ``meta``: small
    JSON-able dict (step counters, mesh axes — informational only; a
    restore never requires the writing mesh).
    """
    index = {"format": FORMAT_VERSION, "meta": dict(meta or {}),
             "entries": []}
    blobs = []
    offset = 0
    for name, arr, spec in entries:
        host, dtype = _host(arr)
        raw = host.tobytes()
        index["entries"].append({
            "name": str(name),
            "dtype": dtype,
            "shape": list(host.shape),
            "spec": spec,
            "offset": offset,
            "nbytes": len(raw),
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        })
        blobs.append(raw)
        offset += len(raw)
    index_raw = json.dumps(index).encode()
    with atomic_path(fname) as tmp:
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", len(index_raw)))
            f.write(index_raw)
            for raw in blobs:
                f.write(raw)


def load_index(fname):
    """Read and validate just the header + index (cheap: no payloads)."""
    with open(fname, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise MXNetError(
                "%s is not a global checkpoint (bad magic %r; expected "
                "MXGC1)" % (fname, magic))
        hdr = f.read(8)
        if len(hdr) < 8:
            raise MXNetError("global checkpoint %s: truncated header"
                             % fname)
        (index_len,) = struct.unpack("<Q", hdr)
        index_raw = f.read(index_len)
        if len(index_raw) < index_len:
            raise MXNetError("global checkpoint %s: truncated index"
                             % fname)
        try:
            index = json.loads(index_raw.decode())
        except ValueError as e:
            raise MXNetError(
                "global checkpoint %s: corrupt index (%s)" % (fname, e))
        data_start = len(_MAGIC) + 8 + index_len
    return index, data_start


def load_global(fname):
    """Read a checkpoint back: ``(entries, meta)``.

    ``entries`` is an ordered dict ``name -> {"array": np.ndarray,
    "dtype": name, "spec": wire}`` with every payload's crc32 verified —
    corruption raises :class:`MXNetError` naming the entry.  A bfloat16
    entry's array holds its uint16 bits.
    """
    index, data_start = load_index(fname)
    out = {}
    with open(fname, "rb") as f:
        for ent in index["entries"]:
            name = ent["name"]
            f.seek(data_start + int(ent["offset"]))
            raw = f.read(int(ent["nbytes"]))
            if len(raw) < int(ent["nbytes"]):
                raise MXNetError(
                    "global checkpoint %s: entry %r truncated (%d of %d "
                    "bytes on disk) — the file was cut short after the "
                    "index was written" % (fname, name, len(raw),
                                           int(ent["nbytes"])))
            if (zlib.crc32(raw) & 0xFFFFFFFF) != int(ent["crc32"]):
                raise MXNetError(
                    "global checkpoint %s: entry %r failed its checksum "
                    "(stored crc32 %d) — the file is corrupt; restore "
                    "from an earlier checkpoint" % (fname, name,
                                                    int(ent["crc32"])))
            dtype = np.uint16 if ent["dtype"] == _BF16 \
                else np.dtype(ent["dtype"])
            arr = np.frombuffer(raw, dtype=dtype) \
                .reshape([int(d) for d in ent["shape"]]).copy()
            out[name] = {"array": arr, "dtype": ent["dtype"],
                         "spec": ent["spec"]}
    return out, index.get("meta", {})
