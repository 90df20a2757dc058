"""Reference-compatible ``.params`` binary serialization.

Byte-for-byte implementation of the reference NDArray container format
(``src/ndarray/ndarray.cc:1586-1860``):

    uint64  0x112 (kMXAPINDArrayListMagic)      ndarray.cc:1829
    uint64  0 (reserved)
    uint64  n_arrays
      per array (NDArray::Save, ndarray.cc:1597):
        uint32  magic: 0xF993fac9 (V2) / 0xF993faca (V3, np-shape)
        int32   storage type (0 = default/dense)
        [sparse only] storage shape: int32 ndim + int64[ndim]
        shape:  int32 ndim + int64[ndim]            tuple.h:704
        ctx:    int32 dev_type, int32 dev_id        base.h:157
        int32   type flag (mshadow/base.h:307)
        raw C-order data bytes
        [sparse only] per aux: raw aux bytes
    uint64  n_names
      per name: uint64 length + bytes

Loading also accepts V1 (0xF993fac8) and the pre-V1 legacy layout where
the leading uint32 is the ndim itself (ndarray.cc LegacyLoad:1688),
so checkpoints from any reference version import directly.
"""
from __future__ import annotations

import struct

import numpy as _np

from ..base import MXNetError

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

# mshadow/base.h:307 type flags
_FLAG2DTYPE = {
    0: _np.float32, 1: _np.float64, 2: _np.float16, 3: _np.uint8,
    4: _np.int32, 5: _np.int8, 6: _np.int64, 7: _np.bool_,
}
_DTYPE2FLAG = {_np.dtype(v): k for k, v in _FLAG2DTYPE.items()}
_DTYPE2FLAG[_np.dtype("bfloat16") if "bfloat16" in dir(_np) else
            _np.dtype(_np.float16)] = 2  # bf16 downcast on save


def _write_shape(out, shape):
    out.append(struct.pack("<i", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _save_one(arr):
    a = _np.ascontiguousarray(arr)
    if a.dtype not in _DTYPE2FLAG:
        if a.dtype == _np.dtype("float64"):
            pass
        elif str(a.dtype) == "bfloat16":
            a = a.astype(_np.float32)
        else:
            a = a.astype(_np.float32)
    flag = _DTYPE2FLAG.get(a.dtype, 0)
    out = [struct.pack("<I", _V2_MAGIC),
           struct.pack("<i", 0)]  # dense storage
    _write_shape(out, a.shape)
    out.append(struct.pack("<ii", 1, 0))  # ctx: cpu(0)
    out.append(struct.pack("<i", flag))
    out.append(a.tobytes())
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("truncated .params file")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]


def _read_shape_i64(r):
    ndim = r.i32()
    return struct.unpack("<%dq" % ndim, r.read(8 * ndim)) if ndim else ()


def _load_one(r):
    magic = r.u32()
    if magic in (_V2_MAGIC, _V3_MAGIC):
        stype = r.i32()
        if stype != 0:
            raise MXNetError("sparse .params entries are not supported "
                             "on load; densify before saving")
        shape = _read_shape_i64(r)
    elif magic == _V1_MAGIC:
        shape = _read_shape_i64(r)
    else:
        # pre-V1: magic IS the ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise MXNetError("corrupt .params entry (ndim=%d)" % ndim)
        shape = struct.unpack("<%dI" % ndim, r.read(4 * ndim)) \
            if ndim else ()
    if len(shape) == 0:
        return None  # is_none() array
    r.i32()  # dev_type
    r.i32()  # dev_id
    flag = r.i32()
    dtype = _FLAG2DTYPE.get(flag)
    if dtype is None:
        raise MXNetError("unknown dtype flag %d in .params" % flag)
    count = 1
    for s in shape:
        count *= s
    data = _np.frombuffer(r.read(count * _np.dtype(dtype).itemsize),
                          dtype=dtype).reshape(shape)
    return data.copy()


def save_params(fname, arrays, names):
    """Write the reference container (parity: MXNDArraySave)."""
    out = [struct.pack("<QQ", _LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        out.append(_save_one(a))
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        raw = n.encode("utf-8")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    with open(fname, "wb") as f:
        f.write(b"".join(out))


def load_params(fname):
    """Read the reference container → (list of np arrays, list of names)."""
    with open(fname, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    header = r.u64()
    if header != _LIST_MAGIC:
        raise MXNetError("not a reference .params file (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_load_one(r) for _ in range(n)]
    n_names = r.u64()
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.read(ln).decode("utf-8"))
    if names and len(names) != len(arrays):
        raise MXNetError("invalid .params file (name/array count)")
    return arrays, names


def is_legacy_file(fname):
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and \
            struct.unpack("<Q", head)[0] == _LIST_MAGIC
    except OSError:
        return False
