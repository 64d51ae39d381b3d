// Causal flash attention for Hopper (sm_90a), forward and backward, in
// f32 or bf16, any head_dim, plain C interface.
//
// Replaces mxnet_tpu/ops/nn.py _flash_attention, which calls jax's
// library Pallas kernel for the TPU (jax.experimental.pallas.ops.tpu.
// flash_attention) on bf16 or f32 inputs: its forward kernel, and the
// two backward kernels that compute dK/dV and dQ.  Inputs are
// contiguous head-major (B, H, S, D) of one element type T (float or
// __nv_bfloat16), any S and any D; the kernels mask the ragged last tile
// themselves, so the TPU's head_dim % 128 and seq % 512 gates do not
// carry over.  The log-sum-exp L and Dr = rowsum(dO * O) are f32.
//
//   mx_flash_fwd:     O = softmax(Q K^T * scale, causal) V, and the
//                     per-row log-sum-exp L.
//   mx_flash_bwd_dkv: P = exp(Q K^T * scale - L) recomputed, then
//                     dV = P^T dO and dK = (P * (dO V^T - Dr) * scale)^T Q,
//                     where Dr = rowsum(dO * O) comes in precomputed.
//   mx_flash_bwd_dq:  dQ = (P * (dO V^T - Dr) * scale) K.
//
// Numerics follow the TPU kernel: T is read from device memory by the
// kernel itself and widened to f32 in shared memory; every product
// accumulates in f32; P (and dS) are rounded to T before the products
// that consume them (p.astype(v.dtype), ds.astype(q.dtype) in the jax
// kernel), while the softmax sum l uses the unrounded P; outputs are
// rounded to T once, at the end.  For T = float the roundings are the
// identity.
//
// What bounds them on the H100: a causal forward does about
// 2 * B * H * S^2 * D flops (two matrix products over the lower
// triangle) on S * D * 4 * sizeof(T) bytes per head: at S = 1024,
// D = 128 that is ~64 flops per byte in f32 and ~128 in bf16, so all
// three are bound by operations.  These kernels run the products as f32
// FMAs on the CUDA cores (67 TFLOP/s), in bf16 too: a bf16 tensor-core
// redesign (mma/wgmma, TMA) is later work, and until then the bf16 forms
// run at about the f32 forms' time while their bound drops to the bf16
// tensor-core rate.
//
// Design: one thread block of 256 threads per (batch * head, tile of 64
// query rows, chunk of 128 output columns) for the forward and dQ, and
// per (batch * head, tile of 64 keys, chunk of 128 output columns) for
// dK/dV.  The TPU kernel walked its key (or query) blocks in a
// sequential grid dimension and carried the running softmax and the
// accumulators in VMEM scratch between grid steps; here a loop inside
// the block takes the place of that dimension, and the carry lives in
// registers, so nothing crosses between blocks: no atomics, and no S x S
// tensor in device memory.  The loops stop at the causal diagonal
// (forward and dQ walk key tiles 0..i, dK/dV walks query tiles j..end).
//
// Head_dim is tiled.  Shared memory holds tiles of 64 rows by 128
// columns of head_dim, f32, with a row stride of 129 floats (the 16
// threads reading 16 rows at one column hit 16 banks), so a block's
// shared memory does not grow with D (82.7 KB forward, 166 KB dK/dV,
// 149 KB dQ).  The scores Q K^T and dO V^T are sums over all of D: they
// are accumulated chunk by chunk, each chunk of the operands staged in
// turn.  The output accumulators are registers for one chunk of 128
// columns (4 rows x 8 columns a thread), and the grid's third dimension
// walks the chunks: a block recomputes the scores for its chunk, so at
// D = 256 the score products run twice, which costs a third more
// operations in all and keeps the register tile of D <= 128.  When D <=
// 128 the resident operand (Q in the forward and dQ, K and V in dK/dV)
// is staged once, as before the tiling.  A thread computes a 4 x 4
// block of the 64 x 64 score tile (rows ty * 4 + i, columns tx + 16 * j;
// the 16 threads sharing a row reduce its max and sum with shuffles
// inside a half warp).  Query tiles run longest first, so the blocks
// with the most key tiles start in the first wave.  Exponentials use
// expf and logf (no fast math), so the f32 results hold the f32
// tolerance against the plain PyTorch version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                    // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kDC = 128;                     // head_dim columns per chunk
constexpr int kDPer = kDC / 16;              // output columns per thread
constexpr int kLd = kDC + 1;                 // stride of a staged chunk tile
constexpr int kPS = kTile + 1;               // stride of a 64 x 64 tile in smem

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and widened back: the rounding of a value that enters
// a product in T
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// copy rows [r0, r0 + kTile), columns [c0, c0 + w) of a (S, D) matrix
// into a (kTile, kLd) f32 shared tile; zeros past row S
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int S, int D, int c0, int w) {
  const int n = kTile * w;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / w, d = idx - r * w;
    dst[r * kLd + d] =
        (r0 + r < S) ? to_f32(src[(size_t)(r0 + r) * D + c0 + d]) : 0.f;
  }
}

__device__ __forceinline__ int chunk_width(int D, int c0) { return min(kDC, D - c0); }

// sum and max over the 16 threads of a half warp that share a row
__device__ __forceinline__ float row_max16(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[i][j] += sum over the w staged columns of a[row ty*4+i] * b[row tx+16j]
__device__ __forceinline__ void dot_tile(const float* as, const float* bs, int w, int ty,
                                         int tx, float s[4][4]) {
#pragma unroll 4
  for (int d = 0; d < w; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[(ty * 4 + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int D, float scale) {
  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;          // longest rows first
  const size_t bh = blockIdx.y;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = chunk_width(D, oc0);
  const T* qg = q + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  extern __shared__ float sm[];
  float* qs = sm;                                   // kTile x kLd
  float* kv = qs + kTile * kLd;                     // kTile x kLd: K, then V
  float* ps = kv + kTile * kLd;                     // kTile x kPS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;

  if (nch == 1) load_tile(qs, qg, q0, S, D, 0, D);  // resident
  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kDC) {
      const int w = chunk_width(D, c0);
      __syncthreads();                              // qs, kv and ps are free
      if (nch > 1) load_tile(qs, qg, q0, S, D, c0, w);
      load_tile(kv, kg, k0, S, D, c0, w);
      __syncthreads();
      dot_tile(qs, kv, w, ty, tx, s);
    }
    // online softmax; every row has a valid key in every tile it visits
    // (key k0 <= its row), so the running max is finite after the first
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = (c <= r && c < S) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float alpha = expf(m[i] - mx);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        ls += s[i][j];
      }
      ls = row_sum16(ls);
      l[i] = l[i] * alpha + ls;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kDPer; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kPS + tx + 16 * j] = rnd<T>(s[i][j]);
    }
    __syncthreads();                                // K read, P written
    load_tile(kv, vg, k0, S, D, oc0, ow);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kDPer; ++cc) {
        const int d = tx + 16 * cc;
        if (d < ow) {
          const float vv = kv[c * kLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float inv = 1.f / l[i];
    T* orow = o + (bh * S + r) * D + oc0;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < ow) orow[d] = from_f32<T>(acc[i][cc] * inv);
    }
    if (tx == 0 && blockIdx.z == 0) lse[bh * S + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------
// backward: both kernels recompute the score tile and dO V^T chunk by
// chunk of D; rows ty * 4 + i are query rows, columns tx + 16 * j keys
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int D, float scale) {
  const int nt = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;                        // most query tiles first
  const size_t bh = blockIdx.y;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = chunk_width(D, oc0);
  const T* qg = q + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  const T* dog = dout + bh * S * D;
  const float* lg = lse + bh * S;
  const float* dg = delta + bh * S;
  extern __shared__ float sm[];
  float* ks = sm;                                   // kTile x kLd each
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* ps = dos + kTile * kLd;                    // kTile x kPS each
  float* dss = ps + kTile * kPS;
  float* ls = dss + kTile * kPS;                    // kTile
  float* dls = ls + kTile;                          // kTile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;

  if (nch == 1) {                                   // resident
    load_tile(ks, kg, k0, S, D, 0, D);
    load_tile(vs, vg, k0, S, D, 0, D);
  }
  float adk[4][kDPer], adv[4][kDPer];             // keys ty * 4 + i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDPer; ++c) {
      adk[i][c] = 0.f;
      adv[i][c] = 0.f;
    }

  for (int qt = kt; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int c0 = 0; c0 < D; c0 += kDC) {
      const int w = chunk_width(D, c0);
      __syncthreads();                              // every tile is free
      if (nch > 1) {
        load_tile(ks, kg, k0, S, D, c0, w);
        load_tile(vs, vg, k0, S, D, c0, w);
      }
      load_tile(qs, qg, q0, S, D, c0, w);
      load_tile(dos, dog, q0, S, D, c0, w);
      if (c0 == 0 && tid < kTile) {
        ls[tid] = (q0 + tid < S) ? lg[q0 + tid] : 0.f;
        dls[tid] = (q0 + tid < S) ? dg[q0 + tid] : 0.f;
      }
      __syncthreads();
      dot_tile(qs, ks, w, ty, tx, s);
      dot_tile(dos, vs, w, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const float p = (c <= r && r < S) ? expf(s[i][j] * scale - ls[rl]) : 0.f;
        ps[rl * kPS + cl] = rnd<T>(p);
        dss[rl * kPS + cl] = rnd<T>(p * (dp[i][j] - dls[rl]) * scale);
      }
    }
    if (nch > 1) {                                  // this block's columns
      __syncthreads();
      load_tile(qs, qg, q0, S, D, oc0, ow);
      load_tile(dos, dog, q0, S, D, oc0, ow);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[r * kPS + ty * 4 + i];
        ds[i] = dss[r * kPS + ty * 4 + i];
      }
#pragma unroll
      for (int cc = 0; cc < kDPer; ++cc) {
        const int d = tx + 16 * cc;
        if (d < ow) {
          const float g = dos[r * kLd + d], x = qs[r * kLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][cc] = fmaf(p[i], g, adv[i][cc]);
            adk[i][cc] = fmaf(ds[i], x, adk[i][cc]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= S) continue;
    T* dkr = dk + (bh * S + c) * D + oc0;
    T* dvr = dv + (bh * S + c) * D + oc0;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < ow) {
        dkr[d] = from_f32<T>(adk[i][cc]);
        dvr[d] = from_f32<T>(adv[i][cc]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int D, float scale) {
  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;          // longest rows first
  const size_t bh = blockIdx.y;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = chunk_width(D, oc0);
  const T* qg = q + bh * S * D;
  const T* dog = dout + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  extern __shared__ float sm[];
  float* qs = sm;                                   // kTile x kLd each
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;                    // kTile x kPS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;

  if (nch == 1) {                                   // resident
    load_tile(qs, qg, q0, S, D, 0, D);
    load_tile(dos, dog, q0, S, D, 0, D);
  }
  float lr[4], dr[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lr[i] = r < S ? lse[bh * S + r] : 0.f;
    dr[i] = r < S ? delta[bh * S + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int c0 = 0; c0 < D; c0 += kDC) {
      const int w = chunk_width(D, c0);
      __syncthreads();                              // every tile is free
      if (nch > 1) {
        load_tile(qs, qg, q0, S, D, c0, w);
        load_tile(dos, dog, q0, S, D, c0, w);
      }
      load_tile(ks, kg, k0, S, D, c0, w);
      load_tile(vs, vg, k0, S, D, c0, w);
      __syncthreads();
      dot_tile(qs, ks, w, ty, tx, s);
      dot_tile(dos, vs, w, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const float p = (c <= r && r < S) ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[rl * kPS + cl] = rnd<T>(p * (dp[i][j] - dr[i]) * scale);
      }
    }
    if (nch > 1) {                                  // this block's columns
      __syncthreads();
      load_tile(ks, kg, k0, S, D, oc0, ow);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kDPer; ++cc) {
        const int d = tx + 16 * cc;
        if (d < ow) {
          const float kk = ks[c * kLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(ds[i], kk, acc[i][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    T* dqr = dq + (bh * S + r) * D + oc0;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < ow) dqr[d] = from_f32<T>(acc[i][cc]);
    }
  }
}

constexpr size_t kFwdSmem = sizeof(float) * (2 * kTile * kLd + kTile * kPS);
constexpr size_t kDkvSmem = sizeof(float) * (4 * kTile * kLd + 2 * kTile * kPS + 2 * kTile);
constexpr size_t kDqSmem = sizeof(float) * (4 * kTile * kLd + kTile * kPS);

template <typename F>
cudaError_t prepare(F fn, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_of(int BH, int S, int D) {
  return dim3((S + kTile - 1) / kTile, BH, (D + kDC - 1) / kDC);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
        int D, float scale, int device, void* stream) {
  cudaError_t err = prepare(flash_fwd_kernel<T>, kFwdSmem, device);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T><<<grid_of(BH, S, D), kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dk, void* dv, int BH, int S, int D, float scale,
        int device, void* stream) {
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T>, kDkvSmem, device);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T><<<grid_of(BH, S, D), kThreads, kDkvSmem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dqp, int BH, int S, int D, float scale, int device,
       void* stream) {
  cudaError_t err = prepare(flash_bwd_dq_kernel<T>, kDqSmem, device);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T><<<grid_of(BH, S, D), kThreads, kDqSmem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dqp, S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dk, dv, dq);
// lse and delta are f32 always.
// q, k, v, o: (BH, S, D) contiguous; lse: (BH, S)
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int D, float scale, int dtype, int device, void* stream) {
  return dtype == 1 ? fwd<__nv_bfloat16>(q, k, v, o, lse, BH, S, D, scale, device, stream)
                    : fwd<float>(q, k, v, o, lse, BH, S, D, scale, device, stream);
}

// delta = rowsum(dO * O): (BH, S)
int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                     int D, float scale, int dtype, int device, void* stream) {
  return dtype == 1 ? dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale,
                                         device, stream)
                    : dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, device,
                                 stream);
}

int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dqp, int BH, int S, int D,
                    float scale, int dtype, int device, void* stream) {
  return dtype == 1 ? dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dqp, BH, S, D, scale,
                                        device, stream)
                    : dq<float>(q, k, v, dout, lse, delta, dqp, BH, S, D, scale, device,
                                stream);
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
