"""Build and load the hand-written CUDA kernels.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the repository root, then loaded
with ``ctypes``.  The library name carries a hash of the source, of
every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded.  Sources that include no PyTorch header compile in seconds;
``torch.utils.cpp_extension.load`` would take minutes for the same
file.

Nothing here runs at import: the CPU tests import every module, and
the host they run on has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "load", "check", "log_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("paged_attention", "layernorm", "flash_attention", "quant",
           "fused_matmul", "fused_band4d", "rtc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# libraries a source links beyond the CUDA runtime
LINK_LIBS = {"rtc": ("nvrtc", "cuda")}
# the two longest compiles split their device code's optimization over
# the host's cores (nvcc --split-compile, CUDA 12.1+): on an H100 host
# paged_attention.cu took 54 s and flash_attention.cu 35 s in one thread,
# 29 s and 21 s split, with every kernel's ptxas register count unchanged;
# build_all's wall time is the longest of the sources'
SPLIT_COMPILE = ("paged_attention", "flash_attention")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise MXNetError("nvcc not found: the CUDA kernels are built on first "
                     "use and need the CUDA toolkit")


def cuda_lib_dir():
    """The toolkit's library directory, beside the ``nvcc`` in use."""
    root = Path(_nvcc()).resolve().parent.parent
    return root / "lib64" if (root / "lib64").exists() else root / "lib"


def _flags(name):
    """nvcc's flags for ``csrc/<name>.cu``: NVCC_FLAGS, then the
    source's own (placed after the source on the command line)."""
    extra = ("--split-compile=0",) if name in SPLIT_COMPILE else ()
    libs = LINK_LIBS.get(name, ())
    if not libs:
        return NVCC_FLAGS + extra
    lib_dir = cuda_lib_dir()
    return NVCC_FLAGS + extra + ("-L%s" % lib_dir, "-L%s" % (lib_dir / "stubs"),
                                 "-Xlinker", "-rpath=%s" % lib_dir) + \
        tuple("-l" + lib for lib in libs)


def _target(name):
    src = CSRC / (name + ".cu")
    flags = _flags(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return src, flags, BUILD_DIR / ("lib%s-%s.so"
                                    % (name, digest.hexdigest()[:12]))


def log_path(name):
    """The nvcc log of ``csrc/<name>.cu``'s current build (``ptxas``'s
    registers, stack and spills for each kernel: ``-Xptxas=-v``)."""
    return _target(name)[2].with_suffix(".log")


def _start(name):
    """Start nvcc for one source; returns (process, tmp, out) or None
    when the library is already built."""
    src, flags, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    log = open(out.with_suffix(".log"), "w")
    # the source comes before the link flags, so the libraries resolve
    # its symbols
    proc = subprocess.Popen([_nvcc(), *flags[:len(NVCC_FLAGS)], "-o",
                             str(tmp), str(src), *flags[len(NVCC_FLAGS):]],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(name, job):
    proc, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise MXNetError("nvcc failed for %s.cu (exit %d):\n%s"
                         % (name, rc, log[-4000:]))
    os.replace(tmp, out)


def build_all():
    """Compile every kernel source, one ``nvcc`` per source, all started
    together.  Returns the wall seconds taken (0 when all were built)."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
    return time.perf_counter() - t0


def load(name):
    """The loaded ``ctypes.CDLL`` for ``csrc/<name>.cu``, built first
    when needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[2]))
        return lib


def check(lib, kernel, err):
    """Raise when a launch function returned a CUDA error (the value of
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        raise MXNetError("%s: CUDA launch failed: %s (cudaError %d)"
                         % (kernel, lib.mx_cuda_error_string(err).decode(),
                            err))
