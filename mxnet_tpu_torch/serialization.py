"""NDArray files: the reference's binary NDArray list, and npz.

Counterpart of ``mxnet_tpu/serialization.py`` (reference NDArray::Save
and Load, src/ndarray/ndarray.cc:1537-1760).  ``save_ndarray_file``
writes the dmlc binary stream the JAX package writes, byte for byte:
list magic 0x112, each array as V2 magic 0xF993fac9, dense storage,
int64 TShape, a CPU context and the mshadow type flag.  A 0-d array is
saved as shape (1,) (an ndim-0 record means an empty placeholder in the
format).  bfloat16 has no mshadow flag, so a file holding one is written
as the same ``.npz`` container the JAX package falls back to (its bits
as uint16 under a ``__bf16__`` key).  ``load_ndarray_file`` reads the
binary format (the V1 0xF993fac8 and pre-V1 "magic is ndim" layouts
included) or the npz container, into NDArrays on the CPU.

Row-sparse and CSR records wait for the sparse slice (ROADMAP A.6):
reading one raises.
"""
from __future__ import annotations

import io as _io
import struct

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["save_ndarray_file", "load_ndarray_file", "load_ndarray_bytes",
           "host_numpy"]

_LIST_KEY = "__mx_list_%d"
_BF16_KEY = "__bf16__"

_NDLIST_MAGIC = 0x112                 # kMXAPINDArrayListMagic
_ND_V2_MAGIC = 0xF993FAC9             # NDARRAY_V2_MAGIC (storage types)
_ND_V1_MAGIC = 0xF993FAC8             # NDARRAY_V1_MAGIC (int64 TShape)

# mshadow type flags (3rdparty mshadow base.h, used by ndarray.cc Save)
_FLAG_OF_DTYPE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                  "int32": 4, "int8": 5, "int64": 6}
_DTYPE_OF_FLAG = {v: k for k, v in _FLAG_OF_DTYPE.items()}

_STYPE_DEFAULT = 0
_SPARSE_LATER = ("sparse NDArray files come with the sparse slice of the "
                 "PyTorch port (ROADMAP A.6)")


def host_numpy(value):
    """``(numpy array, is_bf16)`` of an NDArray, tensor or numpy array,
    copied to the host: a bfloat16 value comes back as its bits
    (uint16), never widened."""
    from .ndarray.ndarray import NDArray
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_np.uint16), True
        return t.numpy(), False
    a = _np.asarray(value)
    if a.dtype.name == "bfloat16":
        return _np.ascontiguousarray(a).view(_np.uint16), True
    return a, False


def _write_shape(f, shape):
    f.write(struct.pack("<I", len(shape)))
    f.write(_np.asarray(shape, dtype="<i8").tobytes())


def _write_dense(f, arr):
    arr = _np.ascontiguousarray(arr)
    if str(arr.dtype) not in _FLAG_OF_DTYPE:
        arr = arr.astype("float32")
    if arr.ndim == 0:
        arr = arr.reshape(1)
    f.write(struct.pack("<I", _ND_V2_MAGIC))
    f.write(struct.pack("<i", _STYPE_DEFAULT))
    _write_shape(f, arr.shape)
    f.write(struct.pack("<ii", 1, 0))          # Context: kCPU(=1), dev 0
    f.write(struct.pack("<i", _FLAG_OF_DTYPE[str(arr.dtype)]))
    f.write(memoryview(arr.reshape(-1)).cast("B") if arr.size
            else b"")


def save_ndarray_file(fname, data, fmt="mxnet"):
    """Save an NDArray (or tensor, or numpy array), a list of them or a
    str-keyed dict.  ``fmt='mxnet'`` writes the reference binary,
    ``fmt='npz'`` the numpy container; a bfloat16 array forces npz, so
    its type comes back exactly."""
    if isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    elif isinstance(data, (list, tuple)):
        keys, arrays = [], list(data)
    else:
        keys, arrays = [], [data]
    for a in arrays:
        if getattr(a, "stype", "default") != "default":
            raise MXNetError("save: " + _SPARSE_LATER)
    hosts = [host_numpy(a) for a in arrays]
    if fmt == "mxnet" and any(bf16 for _, bf16 in hosts):
        fmt = "npz"
    if fmt == "npz":
        names = keys or [_LIST_KEY % i for i in range(len(arrays))]
        named = {(_BF16_KEY + k if bf16 else k): a
                 for k, (a, bf16) in zip(names, hosts)}
        with open(fname, "wb") as f:
            _np.savez(f, **named)
        return
    if fmt != "mxnet":
        raise MXNetError("save: unknown format %r" % (fmt,))
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _NDLIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a, _ in hosts:
            _write_dense(f, a)
        f.write(struct.pack("<Q", len(keys)))
        for k in keys:
            kb = k.encode("utf-8")
            f.write(struct.pack("<Q", len(kb)))
            f.write(kb)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("Invalid NDArray file format (truncated)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def shape64(self):
        ndim = self.u32()
        return tuple(_np.frombuffer(self.read(8 * ndim), "<i8").tolist())

    def array(self, shape, flag):
        if flag not in _DTYPE_OF_FLAG:
            raise MXNetError("Invalid NDArray file format (type flag %d)"
                             % flag)
        dt = _np.dtype(_DTYPE_OF_FLAG[flag])
        n = 1
        for s in shape:
            n *= int(s)
        return _np.frombuffer(self.read(dt.itemsize * n),
                              dt).reshape(shape).copy()


def _read_ndarray(r):
    """One array from the stream (reference NDArray::Load, both legacy
    layouts included, ndarray.cc:1650/1619), as host numpy."""
    magic = r.u32()
    if magic == _ND_V2_MAGIC:
        stype = r.i32()
        if stype != _STYPE_DEFAULT:
            raise MXNetError("load: " + _SPARSE_LATER)
        shape = r.shape64()
        if len(shape) == 0:
            return _np.zeros((), "float32")
        r.i32(); r.i32()                       # Context (ignored: host)
        return r.array(shape, r.i32())
    if magic == _ND_V1_MAGIC:
        shape = r.shape64()
    else:
        # pre-V1: the magic word IS ndim, with uint32 dims following
        ndim = magic
        if ndim > 32:
            raise MXNetError("Invalid NDArray file format (bad magic)")
        shape = tuple(_np.frombuffer(r.read(4 * ndim), "<u4").tolist())
    if len(shape) == 0:
        return _np.zeros((), "float32")
    r.i32(); r.i32()                           # Context
    return r.array(shape, r.i32())


def _host_nd(a, bf16=False):
    from .ndarray.ndarray import NDArray
    a = _np.ascontiguousarray(a)
    if bf16:
        return NDArray(torch.from_numpy(a.view(_np.int16))
                       .view(torch.bfloat16))
    return NDArray(torch.from_numpy(a))


def _load_reference_binary(buf):
    r = _Reader(buf)
    header, _reserved = r.u64(), r.u64()
    if header != _NDLIST_MAGIC:
        raise MXNetError("Invalid NDArray file format (bad list magic)")
    n = r.u64()
    out = [_host_nd(_read_ndarray(r)) for _ in range(n)]
    nkeys = r.u64()
    keys = [r.read(r.u64()).decode("utf-8") for _ in range(nkeys)]
    if nkeys == 0:
        return out
    if nkeys != n:
        raise MXNetError("Invalid NDArray file format (key count)")
    return dict(zip(keys, out))


def _load_npz(fobj):
    with _np.load(fobj, allow_pickle=False) as npz:
        decoded = {}
        for k in npz.keys():
            a = npz[k]
            if k.startswith(_BF16_KEY):
                decoded[k[len(_BF16_KEY):]] = _host_nd(a.view(_np.uint16),
                                                       bf16=True)
            else:
                decoded[k] = _host_nd(a)
    keys = list(decoded)
    if keys and all(k.startswith("__mx_list_") for k in keys):
        out = [None] * len(keys)
        for k in keys:
            out[int(k[len("__mx_list_"):])] = decoded[k]
        return out
    return decoded


def load_ndarray_file(fname):
    """A list or a str-keyed dict of NDArrays on the CPU."""
    if hasattr(fname, "read"):
        return load_ndarray_bytes(fname.read())
    with open(fname, "rb") as f:
        return load_ndarray_bytes(f.read())


def load_ndarray_bytes(buf):
    """Load a serialized NDArray list from memory (the reference binary
    or the npz container)."""
    buf = bytes(buf)
    if len(buf) >= 8 and struct.unpack("<Q", buf[:8])[0] == _NDLIST_MAGIC:
        return _load_reference_binary(buf)
    return _load_npz(_io.BytesIO(buf))
