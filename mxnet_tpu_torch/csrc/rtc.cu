// Runtime compilation of user CUDA kernels (mx.rtc.CudaModule), plain C
// interface, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/rtc.py PallasKernel._fn, whose pallas_call wraps a
// user's Pallas body and jits it: the TPU package had to refuse MXNet's
// CUDA API there (mxnet_tpu/rtc.py CudaModule) because CUDA cannot target
// a TPU.  On the H100 the reference's own API returns
// (python/mxnet/rtc.py, src/common/rtc.cc): NVRTC compiles the user's
// source to a CUBIN for the card, cuModuleLoadData loads it, and a kernel is
// launched with the user's grid, block and dynamic shared memory on the
// caller's stream.
//
// What bounds it: compilation is host work (tens to hundreds of ms per
// module, once per (source, options, exports), cached by the Python
// side); a launch costs one cuLaunchKernel.  The user's kernel is bounded by
// whatever it does; chip_smoke.py times its examples against their byte
// bounds.
//
// Design: three entry points, each returning 0 or an error code and
// writing a message into the caller's buffer (NVRTC's program log for a
// compile error).
//   mx_rtc_compile       source -> CUBIN (nvrtcGetCUBIN, so nothing is
//                        JIT-compiled at load) -> CUmodule, in the context
//                        current on the calling thread (PyTorch's primary
//                        context of the device, checked with
//                        cuCtxGetCurrent; no context is created here);
//                        name expressions (template instantiations such
//                        as "axpy<double>") are registered before the
//                        compile and their lowered names returned.
//   mx_rtc_get_function  CUfunction by (lowered) name.
//   mx_rtc_launch        cuLaunchKernel with the packed argument cells on
//                        the given stream; above 48 KB of dynamic shared
//                        memory the function's limit is raised first.
// Loaded modules live as long as the process (the Python side caches
// them).
#include <cuda.h>
#include <nvrtc.h>
#include <stdio.h>
#include <string.h>

namespace {

void put(char* buf, int cap, const char* msg) {
  if (buf == nullptr || cap <= 0) return;
  strncpy(buf, msg, (size_t)cap - 1);
  buf[cap - 1] = '\0';
}

int cu_error(CUresult r, const char* what, char* buf, int cap) {
  const char* name = nullptr;
  const char* text = nullptr;
  cuGetErrorName(r, &name);
  cuGetErrorString(r, &text);
  char msg[512];
  snprintf(msg, sizeof(msg), "%s: %s (%s, CUresult %d)", what,
           text ? text : "unknown error", name ? name : "?", (int)r);
  put(buf, cap, msg);
  return (int)r;
}

// NVRTC codes are returned offset so the caller can tell them from
// CUresult codes.
constexpr int kNvrtcBase = 100000;

}  // namespace

extern "C" {

int mx_rtc_compile(const char* source, const char* name, int n_opts,
                   const char** opts, int n_exprs, const char** exprs,
                   char* lowered, int lowered_cap, void** module, char* log,
                   int log_cap) {
  *module = nullptr;
  CUcontext ctx = nullptr;
  CUresult cr = cuCtxGetCurrent(&ctx);
  if (cr != CUDA_SUCCESS)
    return cu_error(cr, "cuCtxGetCurrent", log, log_cap);
  if (ctx == nullptr) {
    put(log, log_cap, "no CUDA context is current on this thread");
    return (int)CUDA_ERROR_INVALID_CONTEXT;
  }
  nvrtcProgram prog;
  nvrtcResult nr = nvrtcCreateProgram(&prog, source, name, 0, nullptr,
                                      nullptr);
  if (nr != NVRTC_SUCCESS) {
    put(log, log_cap, nvrtcGetErrorString(nr));
    return kNvrtcBase + (int)nr;
  }
  for (int i = 0; i < n_exprs; ++i) {
    nr = nvrtcAddNameExpression(prog, exprs[i]);
    if (nr != NVRTC_SUCCESS) {
      put(log, log_cap, nvrtcGetErrorString(nr));
      nvrtcDestroyProgram(&prog);
      return kNvrtcBase + (int)nr;
    }
  }
  nr = nvrtcCompileProgram(prog, n_opts, opts);
  if (nr != NVRTC_SUCCESS) {
    size_t n = 0;
    nvrtcGetProgramLogSize(prog, &n);
    if (log != nullptr && log_cap > 0) {
      char head[128];
      snprintf(head, sizeof(head), "%s:\n", nvrtcGetErrorString(nr));
      size_t h = strlen(head);
      put(log, log_cap, head);
      if ((size_t)log_cap > h + 1 && n > 1) {
        // the log goes after the header, cut to the buffer
        char* tail = log + h;
        size_t room = (size_t)log_cap - h;
        if (n <= room) {
          nvrtcGetProgramLog(prog, tail);
        } else {
          char* full = new char[n];
          nvrtcGetProgramLog(prog, full);
          memcpy(tail, full, room - 1);
          tail[room - 1] = '\0';
          delete[] full;
        }
      }
    }
    nvrtcDestroyProgram(&prog);
    return kNvrtcBase + (int)nr;
  }
  // lowered names, NUL-separated, in the order of exprs
  int off = 0;
  for (int i = 0; i < n_exprs; ++i) {
    const char* low = nullptr;
    nr = nvrtcGetLoweredName(prog, exprs[i], &low);
    if (nr != NVRTC_SUCCESS) {
      put(log, log_cap, nvrtcGetErrorString(nr));
      nvrtcDestroyProgram(&prog);
      return kNvrtcBase + (int)nr;
    }
    int len = (int)strlen(low);
    if (off + len + 1 > lowered_cap) {
      put(log, log_cap, "lowered-name buffer too small");
      nvrtcDestroyProgram(&prog);
      return kNvrtcBase + (int)NVRTC_ERROR_OUT_OF_MEMORY;
    }
    memcpy(lowered + off, low, (size_t)len + 1);
    off += len + 1;
  }
  size_t cubin_size = 0;
  nr = nvrtcGetCUBINSize(prog, &cubin_size);
  if (nr != NVRTC_SUCCESS || cubin_size == 0) {
    put(log, log_cap, nr != NVRTC_SUCCESS ? nvrtcGetErrorString(nr)
        : "NVRTC produced no CUBIN: compile for a real architecture "
          "(--gpu-architecture=sm_90a)");
    nvrtcDestroyProgram(&prog);
    return kNvrtcBase + (int)(nr != NVRTC_SUCCESS
                                  ? nr : NVRTC_ERROR_INVALID_OPTION);
  }
  char* cubin = new char[cubin_size];
  nr = nvrtcGetCUBIN(prog, cubin);
  nvrtcDestroyProgram(&prog);
  if (nr != NVRTC_SUCCESS) {
    delete[] cubin;
    put(log, log_cap, nvrtcGetErrorString(nr));
    return kNvrtcBase + (int)nr;
  }
  CUmodule mod = nullptr;
  cr = cuModuleLoadData(&mod, cubin);
  delete[] cubin;
  if (cr != CUDA_SUCCESS)
    return cu_error(cr, "cuModuleLoadData", log, log_cap);
  *module = (void*)mod;
  return 0;
}

int mx_rtc_get_function(void* module, const char* name, void** func,
                        char* err, int err_cap) {
  CUfunction f = nullptr;
  CUresult r = cuModuleGetFunction(&f, (CUmodule)module, name);
  if (r != CUDA_SUCCESS)
    return cu_error(r, "cuModuleGetFunction", err, err_cap);
  *func = (void*)f;
  return 0;
}

int mx_rtc_launch(void* func, unsigned gx, unsigned gy, unsigned gz,
                  unsigned bx, unsigned by, unsigned bz, unsigned shared_mem,
                  void* stream, void** args, char* err, int err_cap) {
  CUfunction f = (CUfunction)func;
  CUresult r;
  if (shared_mem > 48 * 1024) {
    r = cuFuncSetAttribute(f, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                           (int)shared_mem);
    if (r != CUDA_SUCCESS)
      return cu_error(r, "cuFuncSetAttribute", err, err_cap);
  }
  r = cuLaunchKernel(f, gx, gy, gz, bx, by, bz, shared_mem, (CUstream)stream,
                     args, nullptr);
  if (r != CUDA_SUCCESS)
    return cu_error(r, "cuLaunchKernel", err, err_cap);
  return 0;
}

}  // extern "C"
