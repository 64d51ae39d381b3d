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
// Forward design: a group of warps takes a row, each thread holding 8
// values of it (two 16-byte vectors of f32, one of bf16 or f16), so a
// 2048-column row takes 8 warps in any of the three types (the fewest warps, 1, 2, 4 or 8, whose
// registers hold the row), and a 256-thread block holds as many groups as
// fit.  The groups take rows in turn over a grid of at most
// kFwdBlocksPerSM blocks an SM, so the serve steps' 8 to 64 rows get a
// group each and the training and prefill shapes (4096 and 8192 rows)
// loop.  x and the residual arrive by 16-byte loads in straight-line
// code (no branch between them; the residual's presence is a template
// argument), and each group issues its next row's loads as soon as it has
// read the current one, so they fly through the two row means and the
// stores.  The row stays in registers: the mean, then the mean of the
// centred squares (the two-pass form the TPU kernel uses, not E[x^2] -
// E[x]^2), each a per-thread sum in order, a butterfly of shuffles and,
// for a group of several warps, one exchange at a barrier of the group
// alone, summed in warp order; the normalised row leaves by 16-byte
// stores.  Each thread owns the same columns in every row, so it loads its
// gamma and beta once.  No shared memory beyond the exchange slots, so no
// per-launch attribute call.  Rows wider than 8 warps hold (2048 columns)
// take a looped form: a block a row, three passes over it (the second and
// third read it again, from L2), the two sums block reductions in warp
// order.  Ragged widths (cols not a multiple of the vector) and misaligned
// rows go element by element through the same forms.  out = ((x + res
// - mean) * rstd) * gamma + beta with each operation rounded as the plain
// version rounds it; rstd is the hardware's rsqrt (within 2 ulp of 1 /
// sqrt: the IEEE division and square root call a slow-path routine whose
// saved registers spilled), 1 / cols comes from the host.  No atomics: two
// runs give the same bits.
//
// Backward design: the TPU kernel summed dgamma and dbeta across its
// grid, which runs in order on one core (dg_ref[...] += ...).  On the GPU
// the blocks run in parallel, so that carry does not exist, and atomics
// would add in a different order on every run.  Instead the reduction
// has two deterministic stages.  Stage 1: each block takes a fixed range
// of rows, and a group of warps takes one row at a time, as many rows at
// once as the block has groups: each thread holds 16 values of a bf16
// or f16 row (two 16-byte vectors) or 8 of an f32 row (two), read and
// written by 16-byte accesses, so a 2048-column row takes 4 warps in
// 16-bit and 8 in f32.  Loads are straight-line code (no branch between
// them) and each group loads its next row as soon as it has read the
// current one, so loads stay in flight through the row means and the
// stores.  x_hat and
// dy * gamma stay in registers between the two row means, which are warp
// shuffles plus, for a group of several warps, one exchange at a barrier
// of the group alone; each thread owns the same columns in every row, so
// its dgamma and dbeta partials stay in registers too.  The block sums
// its groups' partials in group order and writes them to a scratch
// buffer the wrapper allocates.  Wider rows (past 2048 columns in f32,
// 4096 in 16-bit) take a looped form: one row at a time a block, two
// passes (the second reads the row again), partials in shared memory.
// Stage 2: a second kernel sums the partials column by column in a fixed
// order (32 fixed slices per column, then the 32 slice sums in order).
// Two runs on the same inputs give the same bits.  Ragged widths (cols
// not a multiple of the vector) and misaligned rows go element by
// element.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T: N values
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

// columns [c, c + N) of a row, raw, in straight-line code (no branch, so
// a thread's loads of several vectors issue back to back): kVec, one
// 16-byte load (cols % N == 0 and 16-byte aligned rows, so a vector
// never crosses cols; zeros past cols); else element by element, the
// columns past cols reading column 0 and set to zero
template <bool kVec, typename T>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ row, int c, int cols) {
  constexpr int N = Vec16<T>::N;
  if constexpr (kVec) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    return c < cols ? __ldg(reinterpret_cast<const uint4*>(row + c)) : z;
  } else {
    uint4 u;
    T* v = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const T a = row[c + e < cols ? c + e : 0];
      v[e] = c + e < cols ? a : from_f32<T>(0.f);
    }
    return u;
  }
}

// the N values of a raw vector as f32
template <typename T>
__device__ __forceinline__ void widen(float* d, const uint4& u) {
  const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < Vec16<T>::N; ++e) d[e] = to_f32(v[e]);
}

template <bool kVec, typename T>
__device__ __forceinline__ void load_vec(float* d, const T* __restrict__ row, int c, int cols) {
  widen<T>(d, load_raw<kVec>(row, c, cols));
}

template <bool kVec, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ row, const float* d, int c, int cols) {
  constexpr int N = Vec16<T>::N;
  if constexpr (kVec) {
    if (c < cols) {
      uint4 u;
      T* v = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = from_f32<T>(d[e]);
      *reinterpret_cast<uint4*>(row + c) = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (c + e < cols) row[c + e] = from_f32<T>(d[e]);
  }
}

// the sum of a over the warp, the same bits in every lane
__device__ __forceinline__ float warp_sum(float a) {
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
// threads a block, blocks an SM the grid holds at most (the groups loop
// over rows past that); tools/torch_layernorm_tune.py times variants of
// these
constexpr int kFwdThreads = 256, kFwdBlocksPerSM = 4;

// values of a row a thread of the forward keeps in registers: 8 (two
// 16-byte vectors of f32, one of bf16 or f16), so a 2048-column row takes
// 8 warps in any of the three types (16 bf16 values a thread, 4 warps a row, ran 7%
// slower at 4096 x 2048: tools/torch_layernorm_tune.py --fwd)
constexpr int kFwdVals = 8;

// the sum over the block's NT threads, returned to every thread: each
// warp's butterfly, then the warps in order; `red` holds one slot a warp
// and is free again when this returns
template <int NT>
__device__ float block_sum(float a, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = 0.f;
  for (int w = 0; w < NT / 32; ++w) a += red[w];
  __syncthreads();
  return a;
}

// (x + res - mean) * rstd * gamma + beta of one value, each operation
// rounded as the plain version rounds it (no contraction into an FMA)
__device__ __forceinline__ float ln_out(float v, float mu, float rs, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), g), b);
}

// Rows of up to 32 * 8 * VALS columns.  A row belongs to a group of gw
// warps (1, 2, 4 or 8), each thread owning the N-column vectors t, t +
// 32 gw, ... of it (VALS values).  The block's groups take rows
// blockIdx.x * ng + grp, then every gridDim.x * ng rows on; each group
// loads its next row, raw, as soon as it has read the current one.
template <typename T, typename G, bool kVec, bool kRes>
__global__ void __launch_bounds__(kFwdThreads)
layernorm_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const G* __restrict__ gamma, const G* __restrict__ beta,
                          T* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int rows, int cols, float inv_cols,
                          float eps, int gw) {
  constexpr int VALS = kFwdVals, N = Vec16<T>::N, NV = VALS / N;
  // a group's warp sums, by slot: the row sum, then the centred squares
  __shared__ float red[2][kFwdThreads / 32];
  const int gt = 32 * gw, ng = kFwdThreads / gt;
  const int grp = threadIdx.x / gt, t = threadIdx.x % gt;
  const int wg = t >> 5, lane = t & 31;
  // this thread's gamma and beta, and which of its columns lie in the row
  float ga[NV][N], be[NV][N];
  bool in[NV][N];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int c = (t + j * gt) * N + e;
      in[j][e] = c < cols;
      ga[j][e] = to_f32(__ldg(gamma + (c < cols ? c : 0)));
      be[j][e] = to_f32(__ldg(beta + (c < cols ? c : 0)));
    }
  // the sum of a over the group, in every lane: the butterfly, then the
  // group's warps in order through slot `slot` and the group's barrier
  auto group_sum = [&](float a, int slot) {
    a = warp_sum(a);
    if (gw > 1) {
      float* sl = red[slot] + grp * gw;
      if (lane == 0) sl[wg] = a;
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(gt) : "memory");
      a = 0.f;
      for (int w = 0; w < gw; ++w) a += sl[w];
    }
    return a;
  };
  const int stride = gridDim.x * ng;
  int r = blockIdx.x * ng + grp;
  // the raw vectors of row r: x and the residual
  uint4 xr[NV], rr[NV];
  auto fetch = [&](int row) {
    const size_t base = (size_t)row * cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (t + j * gt) * N;
      xr[j] = load_raw<kVec>(x + base, c, cols);
      if constexpr (kRes) rr[j] = load_raw<kVec>(res + base, c, cols);
    }
  };
  if (r < rows) fetch(r);
  for (; r < rows; r += stride) {
    const size_t base = (size_t)r * cols;
    float v[NV][N];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      // columns past cols load as zeros, so they add nothing
      widen<T>(v[j], xr[j]);
      if constexpr (kRes) {
        float rv[N];
        widen<T>(rv, rr[j]);
#pragma unroll
        for (int e = 0; e < N; ++e) v[j][e] += rv[e];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) s += v[j][e];
    }
    if (r + stride < rows) fetch(r + stride);      // the next row's loads fly from here
    const float mu = group_sum(s, 0) * inv_cols;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = in[j][e] ? __fsub_rn(v[j][e], mu) : 0.f;
        q = __fadd_rn(q, __fmul_rn(d, d));
      }
    const float rs = rsqrtf(group_sum(q, 1) * inv_cols + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = ln_out(v[j][e], mu, rs, ga[j][e], be[j][e]);
      store_vec<kVec>(out + base, o, (t + j * gt) * N, cols);
    }
    if (t == 0) {
      mean_out[r] = mu;
      rstd_out[r] = rs;
    }
  }
}

// Rows wider than the register form's 32 * 8 * VALS columns (2048): a
// block a row, three passes over it (the second
// and third read x and the residual again, from L2), the two sums block
// reductions.
template <typename T, typename G, bool kVec, bool kRes>
__global__ void __launch_bounds__(kFwdThreads)
layernorm_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const G* __restrict__ gamma, const G* __restrict__ beta,
                          T* __restrict__ out, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int cols, float inv_cols, float eps) {
  constexpr int N = Vec16<T>::N;
  __shared__ float red[kFwdThreads / 32];
  const size_t base = (size_t)blockIdx.x * cols;
  // x + res at columns [c, c + N), zeros past cols
  auto vals = [&](int c, float* v) {
    load_vec<kVec>(v, x + base, c, cols);
    if constexpr (kRes) {
      float rv[N];
      load_vec<kVec>(rv, res + base, c, cols);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] += rv[e];
    }
  };
  float s = 0.f;
  for (int c = threadIdx.x * N; c < cols; c += kFwdThreads * N) {
    float v[N];
    vals(c, v);
#pragma unroll
    for (int e = 0; e < N; ++e) s += v[e];
  }
  const float mu = block_sum<kFwdThreads>(s, red) * inv_cols;
  float q = 0.f;
  for (int c = threadIdx.x * N; c < cols; c += kFwdThreads * N) {
    float v[N];
    vals(c, v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float d = c + e < cols ? __fsub_rn(v[e], mu) : 0.f;
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
  }
  const float rs = rsqrtf(block_sum<kFwdThreads>(q, red) * inv_cols + eps);
  for (int c = threadIdx.x * N; c < cols; c += kFwdThreads * N) {
    float v[N], o[N];
    vals(c, v);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int cc = c + e < cols ? c + e : 0;
      o[e] = ln_out(v[e], mu, rs, to_f32(gamma[cc]), to_f32(beta[cc]));
    }
    store_vec<kVec>(out + base, o, c, cols);
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rs;
  }
}

// the register form with the fewest warps a row whose registers hold it,
// or the looped form; returns the launch's error
template <typename T, typename G, bool kVec, bool kRes>
int launch_fwd(const void* x, const void* res, const void* gamma, const void* beta, void* out,
               void* mean, void* rstd, int rows, int cols, float eps, cudaStream_t stream) {
  constexpr int V = kFwdVals, kMaxWarps = kFwdThreads / 32;
  const int w = (cols + 32 * V - 1) / (32 * V);
  const float inv_cols = 1.f / (float)cols;
  if (w > kMaxWarps) {
    layernorm_fwd_wide_kernel<T, G, kVec, kRes><<<rows, kFwdThreads, 0, stream>>>(
        (const T*)x, (const T*)res, (const G*)gamma, (const G*)beta, (T*)out, (float*)mean,
        (float*)rstd, cols, inv_cols, eps);
    return (int)cudaGetLastError();
  }
  int gw = 1;
  while (gw < w) gw *= 2;
  const int ng = kMaxWarps / gw;
  const int64_t want = ((int64_t)rows + ng - 1) / ng;
  const int cap = kFwdBlocksPerSM * tc::kSMs;
  const int nblk = (int)(want < cap ? want : cap);
  layernorm_fwd_rows_kernel<T, G, kVec, kRes><<<nblk, kFwdThreads, 0, stream>>>(
      (const T*)x, (const T*)res, (const G*)gamma, (const G*)beta, (T*)out, (float*)mean,
      (float*)rstd, rows, cols, inv_cols, eps, gw);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch(const void* x, const void* res, const void* gamma, const void* beta, void* out,
           void* mean, void* rstd, int rows, int cols, float eps, cudaStream_t s) {
  // 16-byte loads and stores when every row starts 16-byte aligned
  const bool vec = cols % Vec16<T>::N == 0 && tc::aligned16(x) && tc::aligned16(out) &&
                   (res == nullptr || tc::aligned16(res));
  if (res == nullptr)
    return vec ? launch_fwd<T, G, true, false>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s)
               : launch_fwd<T, G, false, false>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  return vec ? launch_fwd<T, G, true, true>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s)
             : launch_fwd<T, G, false, true>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------
constexpr int kBwdThreads = 256;             // 8 warps
constexpr int kReduceCols = 32;              // columns per stage-2 block
constexpr int kReduceSlices = 32;            // partial-sum slices per column

// values of a row a thread keeps in registers: two 16-byte vectors of
// bf16 or f16; else 8 (16 f32 spill with the next row's loads in flight:
// tools/torch_layernorm_tune.py)
template <typename T, bool kVec> __host__ __device__ constexpr int bwd_vals() {
  return kVec && sizeof(T) == 2 ? 16 : 8;
}

// the two sums over the block, returned to every thread
__device__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kBwdThreads / 32 + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kBwdThreads / 32; ++w) {
    a += red[w];
    b += red[kBwdThreads / 32 + w];
  }
  __syncthreads();
}


// Stage 1, rows of up to 32 GW VALS columns.  A row belongs to a group
// of GW warps (at 2048 columns 4 in 16-bit, 8 in f32), each thread owning
// the N-column vectors t, t + 32 GW, ... of it (VALS values):
// its x (+ residual) and dy arrive by 16-byte loads, x_hat and dy * gamma
// stay in registers between the two row means, which are warp shuffles
// (and, when GW > 1, one exchange between the group's warps at a named
// barrier of the group alone), and dx leaves by 16-byte stores.  The
// block's 256 / (32 GW) groups take rows [blockIdx.x * rows_per_block,
// ...) in turn, and each group loads its next row, raw, as soon as it
// has read the current one, so its loads fly during the row means and
// the stores.  Each thread keeps its columns' dgamma and dbeta partials
// in registers over all its rows (gamma comes from L1 each row); at the
// end the block sums its groups' partials in group order into
// part[0][blockIdx.x][:] and part[1][blockIdx.x][:].
template <typename T, typename G, int GW, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 2)
layernorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const G* __restrict__ gamma, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const T* __restrict__ dy,
                          T* __restrict__ dx, float* __restrict__ part, int rows, int cols,
                          int rows_per_block) {
  constexpr int VALS = bwd_vals<T, kVec>(), N = Vec16<T>::N, NV = VALS / N;
  constexpr int GT = 32 * GW, NG = kBwdThreads / GT;  // threads a row, rows at a time
  constexpr int CW = GT * VALS;                       // the widest row
  __shared__ float red[2][NG][GW][2];    // the row sums between a group's warps, by row parity
  extern __shared__ float psum[];        // the groups' partials: NG x (dgamma CW, dbeta CW)
  const int grp = threadIdx.x / GT, t = threadIdx.x % GT;
  const int wg = t >> 5, lane = t & 31;
  float dg[NV][N], db[NV][N];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      dg[j][e] = 0.f;
      db[j][e] = 0.f;
    }
  const float inv_cols = 1.f / (float)cols;
  const int r1 = min((blockIdx.x + 1) * rows_per_block, rows);
  int r = blockIdx.x * rows_per_block + grp;
  // the raw vectors of row r: x, the residual, dy
  uint4 xr[NV], rr[NV], dr[NV];
  auto fetch = [&](int row) {
    const size_t base = (size_t)row * cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (t + j * GT) * N;
      xr[j] = load_raw<kVec>(x + base, c, cols);
      dr[j] = load_raw<kVec>(dy + base, c, cols);
      if (res != nullptr) rr[j] = load_raw<kVec>(res + base, c, cols);
    }
  };
  if (r < r1) fetch(r);
  for (int it = 0; r < r1; r += NG, ++it) {
    const size_t base = (size_t)r * cols;
    const float mu = mean[r], rs = rstd[r];
    float xh[NV][N], g[NV][N];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      // columns past cols load as zeros: dy = 0 there, so they add nothing
      const int c = (t + j * GT) * N;
      float xv[N], dv[N];
      widen<T>(xv, xr[j]);
      widen<T>(dv, dr[j]);
      if (res != nullptr) {
        float rv[N];
        widen<T>(rv, rr[j]);
#pragma unroll
        for (int e = 0; e < N; ++e) xv[e] += rv[e];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        xh[j][e] = (xv[e] - mu) * rs;
        g[j][e] = dv[e] * to_f32(__ldg(gamma + (c + e < cols ? c + e : 0)));
        dg[j][e] += dv[e] * xh[j][e];
        db[j][e] += dv[e];
        s1 += g[j][e];
        s2 += g[j][e] * xh[j][e];
      }
    }
    if (r + NG < r1) fetch(r + NG);      // the next row's loads fly from here
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (GW > 1) {
      float(&slot)[GW][2] = red[it & 1][grp];
      if (lane == 0) {
        slot[wg][0] = s1;
        slot[wg][1] = s2;
      }
      asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(GT) : "memory");
      s1 = 0.f;
      s2 = 0.f;
#pragma unroll
      for (int w = 0; w < GW; ++w) {
        s1 += slot[w][0];
        s2 += slot[w][1];
      }
    }
    const float m1 = s1 * inv_cols, m2 = s2 * inv_cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float d[N];
#pragma unroll
      for (int e = 0; e < N; ++e) d[e] = rs * (g[j][e] - m1 - xh[j][e] * m2);
      store_vec<kVec>(dx + base, d, (t + j * GT) * N, cols);
    }
  }
  // the block's partials: its groups' in group order
  float* pg = psum + (size_t)grp * 2 * CW;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int c = (t + j * GT) * N + e;
      pg[c] = dg[j][e];
      pg[CW + c] = db[j][e];
    }
  __syncthreads();
  float* pdg = part + (size_t)blockIdx.x * cols;
  float* pdb = part + ((size_t)gridDim.x + blockIdx.x) * cols;
  for (int c = threadIdx.x; c < cols; c += kBwdThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      a += psum[(size_t)k * 2 * CW + c];
      b += psum[(size_t)k * 2 * CW + CW + c];
    }
    pdg[c] = a;
    pdb[c] = b;
  }
}

// Stage 1 for rows wider than the register form's 32 * 8 * VALS
// columns (2048 in f32, 4096 in 16-bit): the block takes one row at a time, in two passes over it
// (the second reads x, the residual and dy again, from L2), with the
// dgamma and dbeta partials in shared memory (each thread owns the same
// columns in every row, so no barrier guards them) and the row means a
// block reduction.
template <typename T, typename G, bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
layernorm_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          const G* __restrict__ gamma, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const T* __restrict__ dy,
                          T* __restrict__ dx, float* __restrict__ part, int rows, int cols,
                          int rows_per_block) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ float psum[];        // dgamma, then dbeta partials: 2 cols
  __shared__ float red[2 * kBwdThreads / 32];
  for (int c = threadIdx.x; c < 2 * cols; c += kBwdThreads) psum[c] = 0.f;
  __syncthreads();
  const float inv_cols = 1.f / (float)cols;
  const int r1 = min((blockIdx.x + 1) * rows_per_block, rows);
  // x_hat and dy * gamma of columns [c, c + N), and dy
  auto row_vals = [&](size_t base, int c, float mu, float rs, float* xh, float* g, float* dv) {
    float xv[N];
    load_vec<kVec>(xv, x + base, c, cols);
    load_vec<kVec>(dv, dy + base, c, cols);
    if (res != nullptr) {
      float rv[N];
      load_vec<kVec>(rv, res + base, c, cols);
#pragma unroll
      for (int e = 0; e < N; ++e) xv[e] += rv[e];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      xh[e] = (xv[e] - mu) * rs;
      g[e] = dv[e] * to_f32(gamma[c + e < cols ? c + e : 0]);
    }
  };
  for (int r = blockIdx.x * rows_per_block; r < r1; ++r) {
    const size_t base = (size_t)r * cols;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x * N; c < cols; c += kBwdThreads * N) {
      float xh[N], g[N], dv[N];
      row_vals(base, c, mu, rs, xh, g, dv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (c + e < cols) {
          psum[c + e] += dv[e] * xh[e];
          psum[cols + c + e] += dv[e];
        }
        s1 += g[e];
        s2 += g[e] * xh[e];
      }
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 * inv_cols, m2 = s2 * inv_cols;
    for (int c = threadIdx.x * N; c < cols; c += kBwdThreads * N) {
      float xh[N], g[N], dv[N], d[N];
      row_vals(base, c, mu, rs, xh, g, dv);
#pragma unroll
      for (int e = 0; e < N; ++e) d[e] = rs * (g[e] - m1 - xh[e] * m2);
      store_vec<kVec>(dx + base, d, c, cols);
    }
  }
  float* pdg = part + (size_t)blockIdx.x * cols;
  float* pdb = part + ((size_t)gridDim.x + blockIdx.x) * cols;
  for (int c = threadIdx.x * N; c < cols; c += kBwdThreads * N)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (c + e < cols) {
        pdg[c + e] = psum[c + e];
        pdb[c + e] = psum[cols + c + e];
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

template <typename T, typename G, int GW, bool kVec>
int launch_rows(const void* x, const void* res, const void* gamma, const void* mean,
                const void* rstd, const void* dy, void* dx, void* part, int rows, int cols,
                int rows_per_block, int nblk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kBwdThreads * bwd_vals<T, kVec>();
  const auto fn = layernorm_bwd_rows_kernel<T, G, GW, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<nblk, kBwdThreads, smem, stream>>>((const T*)x, (const T*)res, (const G*)gamma,
                                         (const float*)mean, (const float*)rstd, (const T*)dy,
                                         (T*)dx, (float*)part, rows, cols, rows_per_block);
  return (int)cudaGetLastError();
}

// stage 1 in the register form with the fewest warps a row whose
// registers hold it, or the looped form; returns the launch's error
template <typename T, typename G, bool kVec>
int launch_stage1(const void* x, const void* res, const void* gamma, const void* mean,
                  const void* rstd, const void* dy, void* dx, void* part, int rows, int cols,
                  int rows_per_block, int nblk, cudaStream_t stream) {
  constexpr int V = bwd_vals<T, kVec>();
  const int w = (cols + 32 * V - 1) / (32 * V);
  if (w <= 1)
    return launch_rows<T, G, 1, kVec>(x, res, gamma, mean, rstd, dy, dx, part, rows, cols, rows_per_block, nblk, stream);
  if (w <= 2)
    return launch_rows<T, G, 2, kVec>(x, res, gamma, mean, rstd, dy, dx, part, rows, cols, rows_per_block, nblk, stream);
  if (w <= 4)
    return launch_rows<T, G, 4, kVec>(x, res, gamma, mean, rstd, dy, dx, part, rows, cols, rows_per_block, nblk, stream);
  if (w <= 8)
    return launch_rows<T, G, 8, kVec>(x, res, gamma, mean, rstd, dy, dx, part, rows, cols, rows_per_block, nblk, stream);
  const size_t smem = (size_t)2 * cols * sizeof(float);
  const auto fn = layernorm_bwd_wide_kernel<T, G, kVec>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<nblk, kBwdThreads, smem, stream>>>((const T*)x, (const T*)res, (const G*)gamma,
                                         (const float*)mean, (const float*)rstd, (const T*)dy,
                                         (T*)dx, (float*)part, rows, cols, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch_bwd(const void* x, const void* res, const void* gamma, const void* mean,
               const void* rstd, const void* dy, void* dx, void* dgamma, void* dbeta,
               void* part, int rows, int cols, int rows_per_block, cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const int nblk = (rows + rows_per_block - 1) / rows_per_block;
  // 16-byte loads and stores when every row starts 16-byte aligned
  const bool vec = cols % N == 0 && tc::aligned16(x) && tc::aligned16(dy) && tc::aligned16(dx) &&
                   (res == nullptr || tc::aligned16(res));
  const int err = vec ? launch_stage1<T, G, true>(x, res, gamma, mean, rstd, dy, dx, part, rows,
                                                  cols, rows_per_block, nblk, stream)
                      : launch_stage1<T, G, false>(x, res, gamma, mean, rstd, dy, dx, part, rows,
                                                   cols, rows_per_block, nblk, stream);
  if (err != 0) return err;
  const int ncb = (cols + kReduceCols - 1) / kReduceCols;
  layernorm_bwd_reduce_kernel<G><<<ncb, kReduceCols * kReduceSlices, 0, stream>>>(
      (const float*)part, nblk, cols, (G*)dgamma, (G*)dbeta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16; `res` may be null.
// x and gamma pair f32 and bf16 in any way, f16 only with f16 (the f16
// serving path); any other pairing or an unknown code returns
// cudaErrorInvalidValue and launches nothing
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
  if (x_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  if (x_dtype == 2 && g_dtype == 2)
    return launch<__half, __half>(x, res, gamma, beta, out, mean, rstd, rows, cols, eps, s);
  return (int)cudaErrorInvalidValue;
}

// the backward's two stages; `part` is 2 * ceil(rows / rows_per_block) *
// cols f32 scratch; dgamma and dbeta are written in gamma's dtype, each
// rounded once from its f32 sum.  Pairings as for the forward: x and
// gamma f32 and bf16 in any way, f16 only with f16 (the f16 training
// path); any other pairing or an unknown code returns
// cudaErrorInvalidValue and launches nothing
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
  if (x_dtype == 1 && g_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, res, gamma, mean, rstd, dy, dx,
                                                    dgamma, dbeta, part, rows, cols,
                                                    rows_per_block, s);
  if (x_dtype == 2 && g_dtype == 2)
    return launch_bwd<__half, __half>(x, res, gamma, mean, rstd, dy, dx, dgamma, dbeta, part,
                                      rows, cols, rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
