// Causal flash attention for Hopper (sm_90a), forward and backward, f32,
// plain C interface.
//
// Replaces mxnet_tpu/ops/nn.py _flash_attention, which calls jax's
// library Pallas kernel for the TPU (jax.experimental.pallas.ops.tpu.
// flash_attention): its forward kernel, and the two backward kernels
// that compute dK/dV and dQ.  Inputs are contiguous head-major (B, H, S,
// D) f32, D <= 128, any S; the kernels mask the ragged last tile
// themselves, so the TPU's head_dim % 128 and seq % 512 gates do not
// carry over.
//
//   mx_flash_fwd:     O = softmax(Q K^T * scale, causal) V, and the
//                     per-row log-sum-exp L, both f32.
//   mx_flash_bwd_dkv: P = exp(Q K^T * scale - L) recomputed, then
//                     dV = P^T dO and dK = (P * (dO V^T - Dr))^T Q * scale,
//                     where Dr = rowsum(dO * O) comes in precomputed.
//   mx_flash_bwd_dq:  dQ = (P * (dO V^T - Dr)) K * scale.
//
// What bounds them on the H100: a causal forward does about
// 2 * B * H * S^2 * D flops (two matrix products over the lower
// triangle) on S * D * 4 * 4 bytes per head: at S = 1024, D = 128 that
// is ~64 flops per byte for f32 on the CUDA cores, above the ~20 f32
// flops per byte at which the card's 67 TFLOP/s f32 rate, not its
// 3.35 TB/s, becomes the limit.  So all three are bound by operations.
// With TF32 off (the port's rule) the products are f32 FMAs on the CUDA
// cores; tensor cores (mma/wgmma), TMA and bf16 are later work.
//
// Design: one thread block of 256 threads per (batch * head, tile of 64
// query rows) for the forward and dQ, and per (batch * head, tile of 64
// keys) for dK/dV.  The TPU kernel walked its key (or query) blocks in a
// sequential grid dimension and carried the running softmax and the
// accumulators in VMEM scratch between grid steps; here a loop inside
// the block takes the place of that dimension, and the carry lives in
// registers, so nothing crosses between blocks: no atomics, and no S x S
// tensor in device memory.  The loops stop at the causal diagonal
// (forward and dQ walk key tiles 0..i, dK/dV walks query tiles j..end).
// Each tile is staged in shared memory with a row stride of D + 1 floats,
// so that the 16 threads reading 16 different rows at one column hit 16
// different banks.  A thread computes a 4 x 4 block of the 64 x 64 score
// tile (rows ty * 4 + i, columns tx + 16 * j; the 16 threads sharing a
// row reduce its max and sum with shuffles inside a half warp) and owns
// 4 rows x 8 columns (tx + 16 * k) of the 64 x D output tile.  Query
// tiles run longest first, so the blocks with the most key tiles start
// in the first wave.  Exponentials use expf and logf (no fast math), so
// the results hold the f32 tolerance against the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                    // query rows and keys per tile
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;            // output columns per thread
constexpr int kPS = kTile + 1;               // stride of a 64 x 64 tile in smem

// copy rows [r0, r0 + kTile) of a (S, D) matrix into a (kTile, D + 1)
// shared tile, zeros past row S
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int S, int D) {
  const int ld = D + 1;
  const int n = kTile * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    dst[r * ld + d] = (r0 + r < S) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

// sum and max over the 16 threads of a half warp that share a row
__device__ __forceinline__ float row_max16(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int D, float scale) {
  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;          // longest rows first
  const size_t bh = blockIdx.y;
  const float* qg = q + bh * S * D;
  const float* kg = k + bh * S * D;
  const float* vg = v + bh * S * D;
  const int ld = D + 1;
  extern __shared__ float sm[];
  float* qs = sm;                                   // kTile x ld
  float* kv = qs + kTile * ld;                      // kTile x ld: K, then V
  float* ps = kv + kTile * ld;                      // kTile x kPS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;

  load_tile(qs, qg, q0, S, D);
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
    __syncthreads();                                // kv and ps are free
    load_tile(kv, kg, k0, S, D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
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
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();                                // K read, P written
    load_tile(kv, vg, k0, S, D);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kDPer; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float vv = kv[c * ld + d];
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
    float* orow = o + (bh * S + r) * D;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) orow[d] = acc[i][cc] * inv;
    }
    if (tx == 0) lse[bh * S + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------
// backward: both kernels recompute the score tile and dO V^T with one
// loop over D; rows ty * 4 + i are query rows, columns tx + 16 * j keys
// ---------------------------------------------------------------------
__device__ __forceinline__ void scores_and_dp(const float* qs, const float* dos,
                                              const float* ks, const float* vs, int D,
                                              int ty, int tx, float s[4][4],
                                              float dp[4][4]) {
  const int ld = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty * 4 + i) * ld + d];
      g[i] = dos[(ty * 4 + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ks[(tx + 16 * j) * ld + d];
      w[j] = vs[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int S, int D,
                     float scale) {
  const int nt = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;                        // most query tiles first
  const size_t bh = blockIdx.y;
  const float* qg = q + bh * S * D;
  const float* dog = dout + bh * S * D;
  const float* lg = lse + bh * S;
  const float* dg = delta + bh * S;
  const int ld = D + 1;
  extern __shared__ float sm[];
  float* ks = sm;                                   // kTile x ld each
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* ps = dos + kTile * ld;                     // kTile x kPS each
  float* dss = ps + kTile * kPS;
  float* ls = dss + kTile * kPS;                    // kTile
  float* dls = ls + kTile;                          // kTile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;

  load_tile(ks, k + bh * S * D, k0, S, D);
  load_tile(vs, v + bh * S * D, k0, S, D);
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
    __syncthreads();                                // qs, dos, ps, dss free
    load_tile(qs, qg, q0, S, D);
    load_tile(dos, dog, q0, S, D);
    if (tid < kTile) {
      ls[tid] = (q0 + tid < S) ? lg[q0 + tid] : 0.f;
      dls[tid] = (q0 + tid < S) ? dg[q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const float p = (c <= r && r < S) ? expf(s[i][j] * scale - ls[rl]) : 0.f;
        ps[rl * kPS + cl] = p;
        dss[rl * kPS + cl] = p * (dp[i][j] - dls[rl]);
      }
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
        if (d < D) {
          const float g = dos[r * ld + d], x = qs[r * ld + d];
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
    float* dkr = dk + (bh * S + c) * D;
    float* dvr = dv + (bh * S + c) * D;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dkr[d] = adk[i][cc] * scale;
        dvr[d] = adv[i][cc];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S, int D, float scale) {
  const int nq = (S + kTile - 1) / kTile;
  const int qt = nq - 1 - (int)blockIdx.x;          // longest rows first
  const size_t bh = blockIdx.y;
  const float* kg = k + bh * S * D;
  const float* vg = v + bh * S * D;
  const int ld = D + 1;
  extern __shared__ float sm[];
  float* qs = sm;                                   // kTile x ld each
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;                     // kTile x kPS
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;

  load_tile(qs, q + bh * S * D, q0, S, D);
  load_tile(dos, dout + bh * S * D, q0, S, D);
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
    __syncthreads();                                // ks, vs, dss free
    load_tile(ks, kg, k0, S, D);
    load_tile(vs, vg, k0, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, D, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j, c = k0 + cl;
        const float p = (c <= r && r < S) ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[rl * kPS + cl] = p * (dp[i][j] - dr[i]);
      }
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
        if (d < D) {
          const float kk = ks[c * ld + d];
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
    float* dqr = dq + (bh * S + r) * D;
#pragma unroll
    for (int cc = 0; cc < kDPer; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) dqr[d] = acc[i][cc] * scale;
    }
  }
}

size_t fwd_smem(int D) { return sizeof(float) * (2 * (size_t)kTile * (D + 1) + kTile * kPS); }
size_t dkv_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile);
}
size_t dq_smem(int D) { return sizeof(float) * (4 * (size_t)kTile * (D + 1) + kTile * kPS); }

template <typename F>
cudaError_t prepare(F fn, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// q, k, v, o: (BH, S, D) f32 contiguous; lse: (BH, S) f32; D <= 128
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int D, float scale, int device, void* stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(flash_fwd_kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, BH);
  flash_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, S, D,
      scale);
  return (int)cudaGetLastError();
}

// delta = rowsum(dO * O): (BH, S) f32
int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                     int D, float scale, int device, void* stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = prepare(flash_bwd_dkv_kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, BH);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S, D, scale);
  return (int)cudaGetLastError();
}

int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int BH, int S, int D,
                    float scale, int device, void* stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(flash_bwd_dq_kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, BH);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, S, D, scale);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
