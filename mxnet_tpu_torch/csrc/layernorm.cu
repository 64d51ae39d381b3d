// Fused LayerNorm (+ optional residual add) for Hopper (sm_90a), forward
// and backward, plain C interface.
//
// mx_layernorm_fwd replaces mxnet_tpu/pallas/layernorm.py _ln_forward
// (_ln_fwd_kernel), the forward half of layernorm_fused: out = (x + res -
// mean) * rstd * gamma + beta over the last axis, out in the dtype of x,
// per-row mean and rstd in f32.
//
// mx_layernorm_bwd replaces _ln_backward (_ln_bwd_kernel): from the saved
// mean and rstd, x_hat = (x + res - mean) * rstd, g = dy * gamma,
// dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat)) per row, and
// dgamma = sum_rows dy * x_hat, dbeta = sum_rows dy; the residual's
// gradient is dx itself.
//
// What bounds them on the H100: each input element is read once and each
// output element written once, at a few flops per element, so both are
// bound by bytes.  At the served shapes (8 or 64 rows of 2048) the
// forward's bytes take well under a microsecond, so in practice the
// launch latency bounds it; at the training shape (4096 rows of 2048)
// the backward moves ~100 MB, about 30 us at 3.35 TB/s.
//
// Forward design: one thread block per row.  The row (x plus the
// residual) is staged once into shared memory, so device memory is read
// once; the mean and then the variance of the centred values (the
// two-pass form the TPU kernel uses, not E[x^2] - E[x]^2) are block
// reductions by warp shuffles, and the normalised row is written in one
// more pass over shared memory.
//
// Backward design: the TPU kernel summed dgamma and dbeta across its
// grid, which runs in order on one core (dg_ref[...] += ...).  On the GPU
// the blocks run in parallel, so that carry does not exist, and atomics
// would add in a different order on every run.  Instead the reduction
// has two deterministic stages.  Stage 1: each block takes a fixed range
// of rows, one row at a time; every thread owns the same columns for
// every row, keeps its x_hat and dy * gamma in shared memory between the
// two passes over the row, and adds its columns' dy * x_hat and dy into
// the block's own partial sums; the two row means are one block
// reduction.  The block then writes its partial sums to a scratch buffer
// the wrapper allocates.  Stage 2: a second kernel sums the partials
// column by column in a fixed order (eight fixed slices per column, then
// the eight slice sums in order).  Two runs on the same inputs give the
// same bits.
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

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------
constexpr int kBwdThreads = 256;
constexpr int kReduceCols = 32;              // columns per stage-2 block
constexpr int kReduceSlices = 8;             // partial-sum slices per column

// the two sums over the block, returned to every thread
__device__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    red[warp] = a;
    red[kBwdThreads / 32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < kBwdThreads / 32 ? red[lane] : 0.f;
    float tb = lane < kBwdThreads / 32 ? red[kBwdThreads / 32 + lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      ta += __shfl_xor_sync(0xffffffffu, ta, off);
      tb += __shfl_xor_sync(0xffffffffu, tb, off);
    }
    if (lane == 0) {
      red[0] = ta;
      red[1] = tb;
    }
  }
  __syncthreads();
  a = red[0];
  b = red[1];
  __syncthreads();
}

// stage 1: rows [blockIdx.x * rows_per_block, ...) -> dx and this block's
// partial dgamma / dbeta (part[0][blockIdx.x][:], part[1][blockIdx.x][:])
template <typename T, typename G>
__global__ void __launch_bounds__(kBwdThreads)
layernorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const G* __restrict__ gamma, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const T* __restrict__ dy,
                          T* __restrict__ dx, float* __restrict__ part, int rows,
                          int cols, int rows_per_block) {
  extern __shared__ float sm[];
  float* xh = sm;                // cols: x_hat of the current row
  float* gd = xh + cols;         // cols: dy * gamma of the current row
  float* adg = gd + cols;        // cols: the block's dgamma partial
  float* adb = adg + cols;       // cols: the block's dbeta partial
  __shared__ float red[2 * kBwdThreads / 32];
  // every shared slot below is read and written by the thread that owns
  // its column only, so no barrier is needed between the passes
  for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
    adg[c] = 0.f;
    adb[c] = 0.f;
  }
  const float inv_cols = 1.f / (float)cols;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  for (int r = r0; r < r1; ++r) {
    const size_t base = (size_t)r * cols;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
      float v = to_f32(x[base + c]);
      if (res != nullptr) v += to_f32(res[base + c]);
      const float xhat = (v - mu) * rs;
      const float d = to_f32(dy[base + c]);
      const float g = d * to_f32(gamma[c]);
      xh[c] = xhat;
      gd[c] = g;
      adg[c] += d * xhat;
      adb[c] += d;
      s1 += g;
      s2 += g * xhat;
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 * inv_cols, m2 = s2 * inv_cols;
    for (int c = threadIdx.x; c < cols; c += kBwdThreads)
      dx[base + c] = from_f32<T>(rs * (gd[c] - m1 - xh[c] * m2));
  }
  float* pdg = part + (size_t)blockIdx.x * cols;
  float* pdb = part + ((size_t)gridDim.x + blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
    pdg[c] = adg[c];
    pdb[c] = adb[c];
  }
}

// stage 2: dgamma[c] and dbeta[c] = the sums of the nblk partials, in a
// fixed order: slice s of a column sums partials s, s + 8, s + 16, ...,
// then slice sums 0..7 are added in order
template <typename G>
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
layernorm_bwd_reduce_kernel(const float* __restrict__ part, int nblk, int cols,
                            G* __restrict__ dgamma, G* __restrict__ dbeta) {
  __shared__ float sg[kReduceSlices][kReduceCols];
  __shared__ float sb[kReduceSlices][kReduceCols];
  const int lc = threadIdx.x % kReduceCols, sl = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + lc;
  float a = 0.f, b = 0.f;
  if (c < cols) {
    const float* pg = part + c;
    const float* pb = part + (size_t)nblk * cols + c;
    for (int i = sl; i < nblk; i += kReduceSlices) {
      a += pg[(size_t)i * cols];
      b += pb[(size_t)i * cols];
    }
  }
  sg[sl][lc] = a;
  sb[sl][lc] = b;
  __syncthreads();
  if (sl == 0 && c < cols) {
    float ta = 0.f, tb = 0.f;
    for (int s = 0; s < kReduceSlices; ++s) {
      ta += sg[s][lc];
      tb += sb[s][lc];
    }
    dgamma[c] = from_f32<G>(ta);
    dbeta[c] = from_f32<G>(tb);
  }
}

template <typename T, typename G>
int launch_bwd(const void* x, const void* res, const void* gamma, const void* mean,
               const void* rstd, const void* dy, void* dx, void* dgamma, void* dbeta,
               void* part, int rows, int cols, int rows_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)4 * cols * sizeof(float);
  const int nblk = (rows + rows_per_block - 1) / rows_per_block;
  auto fn = layernorm_bwd_rows_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<nblk, kBwdThreads, smem, stream>>>((const T*)x, (const T*)res, (const G*)gamma,
                                         (const float*)mean, (const float*)rstd,
                                         (const T*)dy, (T*)dx, (float*)part, rows, cols,
                                         rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ncb = (cols + kReduceCols - 1) / kReduceCols;
  layernorm_bwd_reduce_kernel<G><<<ncb, kReduceCols * kReduceSlices, 0, stream>>>(
      (const float*)part, nblk, cols, (G*)dgamma, (G*)dbeta);
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

// the backward's two stages; `part` is 2 * ceil(rows / rows_per_block) *
// cols f32 scratch; dgamma and dbeta are written in gamma's dtype
int mx_layernorm_bwd(const void* x, const void* res, const void* gamma,
                     const void* mean, const void* rstd, const void* dy, void* dx,
                     void* dgamma, void* dbeta, void* part, int rows, int cols,
                     int rows_per_block, int x_dtype, int g_dtype, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && g_dtype == 0)
    return launch_bwd<float, float>(x, res, gamma, mean, rstd, dy, dx, dgamma, dbeta,
                                    part, rows, cols, rows_per_block, s);
  if (x_dtype == 0 && g_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, res, gamma, mean, rstd, dy, dx, dgamma,
                                            dbeta, part, rows, cols, rows_per_block, s);
  if (x_dtype == 1 && g_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, res, gamma, mean, rstd, dy, dx, dgamma,
                                            dbeta, part, rows, cols, rows_per_block, s);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, mean, rstd, dy, dx,
                                                  dgamma, dbeta, part, rows, cols,
                                                  rows_per_block, s);
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
