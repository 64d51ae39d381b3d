// Fused LayerNorm forward (+ optional residual add) for Hopper (sm_90a),
// plain C interface.
//
// Replaces mxnet_tpu/pallas/layernorm.py _ln_forward (_ln_fwd_kernel),
// the forward half of layernorm_fused: out = (x + res - mean) * rstd *
// gamma + beta over the last axis, out in the dtype of x, per-row mean
// and rstd in f32.  The backward kernel comes with the training slice.
//
// What bounds it on the H100: each input element is read once and each
// output element written once, at a few flops per element, so the
// kernel is bound by bytes; at the served shapes (8 or 64 rows of 2048)
// those bytes take well under a microsecond, so in practice the launch
// latency bounds it.
//
// Design: one thread block per row.  The row (x plus the residual) is
// staged once into shared memory, so device memory is read once; the
// mean and then the variance of the centred values (the two-pass form
// the TPU kernel uses, not E[x^2] - E[x]^2) are block reductions by warp
// shuffles, and the normalised row is written in one more pass over
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;

// sum over the block, returned to every thread; `red` holds one slot per
// warp and is free again when this returns
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  t = red[0];
  __syncthreads();
  return t;
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const G* __restrict__ gamma, const G* __restrict__ beta,
                     T* __restrict__ out, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int cols, float eps) {
  extern __shared__ float xs[];              // the row, cols floats
  __shared__ float red[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * cols;
  const float inv_cols = 1.f / (float)cols;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float v = to_f32(x[base + c]);
    if (res != nullptr) v += to_f32(res[base + c]);
    xs[c] = v;
    s += v;
  }
  const float mean = block_sum(s, red) * inv_cols;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float d = xs[c] - mean;
    s2 += d * d;
  }
  const float rstd = 1.f / sqrtf(block_sum(s2, red) * inv_cols + eps);
  for (int c = threadIdx.x; c < cols; c += kThreads)
    out[base + c] = from_f32<T>((xs[c] - mean) * rstd * to_f32(gamma[c]) + to_f32(beta[c]));
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

template <typename T, typename G>
int launch(const void* x, const void* res, const void* gamma, const void* beta,
           void* out, void* mean, void* rstd, int rows, int cols, float eps,
           cudaStream_t stream) {
  const size_t smem = (size_t)cols * sizeof(float);
  auto fn = layernorm_fwd_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<rows, kThreads, smem, stream>>>((const T*)x, (const T*)res, (const G*)gamma,
                                       (const G*)beta, (T*)out, (float*)mean,
                                       (float*)rstd, cols, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; `res` may be null
int mx_layernorm_fwd(const void* x, const void* res, const void* gamma,
                     const void* beta, void* out, void* mean, void* rstd, int rows,
                     int cols, float eps, int x_dtype, int g_dtype, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && g_dtype == 0)
    return launch<float, float>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  if (x_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  if (x_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
