"""mx.rtc: user CUDA kernels compiled at run time (NVRTC) and launched
on NDArrays.

Counterpart of ``mxnet_tpu/rtc.py``.  The JAX package refused MXNet's
CUDA API there (CUDA cannot target a TPU) and offered ``PallasModule``
in its place; on the H100 the reference's API comes back
(python/mxnet/rtc.py), and ``PallasModule`` is the one that refuses::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                    int n) {
      for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
           i += gridDim.x * blockDim.x)
        y[i] += alpha * x[i];
    }'''
    mod = mx.rtc.CudaModule(source)
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), (264, 1, 1), (256, 1, 1))

``CudaModule(source, options=(), exports=())`` compiles for
``sm_90a`` at construction (``csrc/rtc.cu``: NVRTC to a CUBIN, loaded
into PyTorch's context of the device); a compile error raises
``MXNetError`` with NVRTC's log.  ``exports`` are name expressions for
template kernels (``"axpy<double>"``), which ``get_kernel`` then takes
by that name.  Modules are cached per (source, options, exports, device),
so a loop that rebuilds a ``CudaModule`` compiles once.

``get_kernel(name, signature)`` parses a C signature over ``float``,
``double``, ``__half``, ``int8_t``, ``uint8_t``, ``int32_t``/``int`` and
``int64_t``, each a pointer (const or not) or a scalar.  ``launch``
checks every argument against it (an NDArray's dtype and device for a
pointer, a number's kind and range for a scalar), then launches with
``cuLaunchKernel`` on ``torch.cuda.current_stream``, so the kernel is
ordered with the port's other work, and raises on a refused launch.
Kernels run on the card only: a CPU context raises, as MXNet's rtc
did.  ``LAUNCHES[name]`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import numbers
import re
import struct
import threading

import torch

from .base import MXNetError
from .context import Context, current_context
from .kernels import _build
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "LAUNCHES",
           "parse_signature"]

LAUNCHES = {}
_LOG_BYTES = 64 * 1024
_lock = threading.Lock()
_modules = {}           # (digest, device index) -> CUmodule handle

# C type -> (torch dtype, ctypes scalar type)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "int8_t": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_PARAM = re.compile(r"^(const\s+)?(\w+)\s*(\*?)\s*(?:__restrict__\s*)?"
                    r"(\w+)?$")


def parse_signature(signature):
    """``[(is_pointer, is_const, C type, name), ...]`` of a C parameter
    list such as ``"const float *x, float *y, float alpha, int n"``;
    raises for a type outside ``_TYPES``."""
    params = []
    for i, part in enumerate(p.strip() for p in signature.split(",")):
        m = _PARAM.match(re.sub(r"\s+", " ", part))
        if m is None or m.group(2) not in _TYPES:
            raise MXNetError("rtc signature: cannot parse argument %d %r; "
                             "the types are %s, each a pointer or a scalar"
                             % (i, part, ", ".join(sorted(_TYPES))))
        params.append((m.group(3) == "*", m.group(1) is not None,
                       m.group(2), m.group(4) or "arg%d" % i))
    return params


def _preload_nvrtc():
    """Load the toolkit's NVRTC and its builtins library globally before
    ``rtc.cu``'s library, so both resolve from the toolkit that built it
    whatever the loader's search path holds."""
    lib_dir = _build.cuda_lib_dir()
    for pattern in ("libnvrtc-builtins.so*", "libnvrtc.so*"):
        for path in sorted(lib_dir.glob(pattern)):
            ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
            break


def _lib():
    if "rtc" not in _build._libs:
        _preload_nvrtc()
    lib = _build.load("rtc")
    if lib.mx_rtc_compile.argtypes is None:
        p, i, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        u = ctypes.c_uint
        lib.mx_rtc_compile.argtypes = [cp, cp, i, ctypes.POINTER(cp), i,
                                       ctypes.POINTER(cp), cp, i,
                                       ctypes.POINTER(p), cp, i]
        lib.mx_rtc_get_function.argtypes = [p, cp, ctypes.POINTER(p), cp, i]
        lib.mx_rtc_launch.argtypes = [p, u, u, u, u, u, u, u, p,
                                      ctypes.POINTER(p), cp, i]
        for fn in (lib.mx_rtc_compile, lib.mx_rtc_get_function,
                   lib.mx_rtc_launch):
            fn.restype = ctypes.c_int
    return lib


def _gpu(ctx):
    ctx = ctx if ctx is not None else current_context()
    if not isinstance(ctx, Context) or ctx.device_type != "gpu":
        raise MXNetError("mx.rtc runs CUDA kernels on a GPU context, got %s"
                         % (ctx,))
    return ctx.torch_device


def _strings(items):
    arr = (ctypes.c_char_p * max(len(items), 1))()
    for i, s in enumerate(items):
        arr[i] = s.encode()
    return arr


class CudaModule:
    """CUDA source compiled by NVRTC for the card (reference
    ``mx.rtc.CudaModule``).  ``options`` are NVRTC options (``-arch`` is
    set to ``sm_90a``); ``exports`` name template instantiations."""

    def __init__(self, source, options=(), exports=(), ctx=None):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._device = _gpu(ctx)
        self._exports = tuple(exports)
        opts = ("--gpu-architecture=sm_90a",) + tuple(options)
        key = hashlib.sha256("\0".join(
            (source,) + opts + ("|",) + self._exports).encode()).hexdigest()
        with _lock:
            got = _modules.get((key, self._device.index))
            if got is None:
                got = _modules[(key, self._device.index)] = \
                    self._compile(source, opts)
        self._handle, self._lowered = got

    def _compile(self, source, opts):
        lib = _lib()
        log = ctypes.create_string_buffer(_LOG_BYTES)
        lowered = ctypes.create_string_buffer(
            sum(len(e) for e in self._exports) * 8 + 4096)
        handle = ctypes.c_void_p()
        with torch.cuda.device(self._device):
            # makes PyTorch's primary context of the device current here
            torch.cuda.synchronize(self._device)
            rc = lib.mx_rtc_compile(
                source.encode(), b"mx_rtc.cu", len(opts), _strings(opts),
                len(self._exports), _strings(self._exports), lowered,
                len(lowered), ctypes.byref(handle), log, _LOG_BYTES)
        if rc != 0:
            raise MXNetError("mx.rtc.CudaModule: compilation failed (%d):\n%s"
                             % (rc, log.value.decode(errors="replace")))
        names = lowered.raw.split(b"\0")[:len(self._exports)]
        return handle.value, dict(zip(self._exports,
                                      (n.decode() for n in names)))

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with its C ``signature``."""
        params = parse_signature(signature)
        lib = _lib()
        func = ctypes.c_void_p()
        err = ctypes.create_string_buffer(1024)
        with torch.cuda.device(self._device):
            rc = lib.mx_rtc_get_function(
                self._handle, self._lowered.get(name, name).encode(),
                ctypes.byref(func), err, len(err))
        if rc != 0:
            raise MXNetError("mx.rtc: no kernel %r in the module: %s"
                             % (name, err.value.decode()))
        return CudaKernel(name, func.value, params, self._device)


class CudaKernel:
    """A launchable kernel of a CudaModule (reference
    ``mx.rtc.CudaKernel``)."""

    def __init__(self, name, handle, params, device):
        self.name = name
        self._handle = handle
        self._params = params
        self._device = device

    def _cells(self, args, device):
        """One ctypes cell per argument, checked against the signature;
        the caller keeps them alive across the launch."""
        if len(args) != len(self._params):
            raise MXNetError("%s: %d arguments for a signature of %d"
                             % (self.name, len(args), len(self._params)))
        cells = []
        for a, (ptr, const, ctype, pname) in zip(args, self._params):
            dtype, cscalar = _TYPES[ctype]
            if ptr:
                if not isinstance(a, NDArray):
                    raise MXNetError("%s: argument %s is %s* and takes an "
                                     "NDArray, got %s" % (self.name, pname,
                                                          ctype, type(a)))
                t = a._data
                if t.dtype != dtype:
                    raise MXNetError("%s: argument %s is %s* but the NDArray "
                                     "is %s" % (self.name, pname, ctype,
                                                t.dtype))
                if t.device != device:
                    raise MXNetError("%s: argument %s lives on %s, the launch "
                                     "on %s" % (self.name, pname, t.device,
                                                device))
                if not t.is_contiguous():
                    raise MXNetError("%s: argument %s must be contiguous"
                                     % (self.name, pname))
                cells.append(ctypes.c_void_p(t.data_ptr()))
                continue
            if not isinstance(a, numbers.Real) or isinstance(a, bool):
                raise MXNetError("%s: argument %s is a %s scalar, got %r"
                                 % (self.name, pname, ctype, a))
            if dtype.is_floating_point:
                if dtype == torch.float16:
                    cells.append(cscalar(struct.unpack(
                        "<H", struct.pack("<e", float(a)))[0]))
                else:
                    cells.append(cscalar(float(a)))
                continue
            if not isinstance(a, numbers.Integral):
                raise MXNetError("%s: argument %s is %s and takes an int, "
                                 "got %r" % (self.name, pname, ctype, a))
            info = torch.iinfo(dtype)
            if not info.min <= a <= info.max:
                raise MXNetError("%s: argument %s = %d is out of the range "
                                 "of %s" % (self.name, pname, a, ctype))
            cells.append(cscalar(int(a)))
        return cells

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``grid_dims`` and
        ``block_dims`` (up to three each) and ``shared_mem`` bytes of
        dynamic shared memory, on the device's current stream."""
        device = _gpu(ctx)
        if device != self._device:
            raise MXNetError("%s: compiled for %s, launched on %s"
                             % (self.name, self._device, device))
        grid = tuple(grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(block_dims) + (1,) * (3 - len(block_dims))
        cells = self._cells(args, device)
        argv = (ctypes.c_void_p * max(len(cells), 1))(
            *[ctypes.cast(ctypes.pointer(c), ctypes.c_void_p)
              for c in cells])
        lib = _lib()
        err = ctypes.create_string_buffer(1024)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.mx_rtc_launch(self._handle, *grid, *block,
                                   int(shared_mem), stream, argv, err,
                                   len(err))
        del cells, argv
        if rc != 0:
            raise MXNetError("%s: launch failed: %s" % (self.name,
                                                        err.value.decode()))
        with _lock:
            LAUNCHES[self.name] = LAUNCHES.get(self.name, 0) + 1


class PallasModule:
    """The JAX package's runtime-kernel API: Pallas bodies target a TPU,
    so here it raises and names ``CudaModule``."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "mx.rtc.PallasModule runs Pallas kernel bodies, which target a "
            "TPU. On the GPU write the kernel in CUDA C++ and compile it "
            "with mx.rtc.CudaModule(source, options, exports); get_kernel("
            "name, signature).launch(args, mx.gpu(0), grid_dims, "
            "block_dims, shared_mem) runs it.")
