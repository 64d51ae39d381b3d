// Paged-KV-cache attention kernels for Hopper (sm_90a), plain C interface.
//
// mx_paged_decode replaces mxnet_tpu/pallas/attention.py
// paged_decode_attend (_paged_decode_kernel); mx_paged_chunk_prefill
// replaces paged_chunk_prefill_attend (_paged_chunk_prefill_kernel).
// Both keep the JAX functions' layouts: caches (num_blocks, block_size,
// H, D), queries and chunk rows seq-major (.., H, D), block tables and
// positions int32.
//
// What bounds them on the H100: decode reads the K/V rows of every live
// context once, sum_c (pos_c + 1) * H * D * 2 * sizeof(cache) bytes,
// and does 2 flops per element read: far below the 295 flops/byte the
// card needs before compute limits, so it is bound by memory bytes.
// The chunk prefill reads the cached context once and writes its chunk
// rows; every context element then meets up to K = 64 queries, 2 flops
// each, on the f32 CUDA cores (no tensor cores here), so it is bound by
// f32 operations rather than bytes.
//
// Design: the TPU grid was (slot, table block), walked in order on one
// core with the softmax state carried in scratch from step to step.
// Here blocks run in parallel, so each (slot, head) pair is one thread
// block that loops over its own table entries and keeps the online
// softmax in registers and shared memory: C * H blocks (128 at the
// served shape).  K/V rows of one head are D contiguous values at a
// stride of H * D, so a warp reads each row as coalesced 128-byte
// lines.  The chunk prefill gives each (row, head, group of 8 chunk
// rows) one block: H * B * K / 8 blocks (128 at the served shape).  A
// block writes only its own chunk rows' slice of its head into the
// cache, reads cache rows only below `start` (which no block writes)
// and takes the in-chunk keys from the chunk input itself, so every
// block's writes are disjoint from every block's reads and from the
// other blocks' writes, and no block waits for another.  The blocks of
// one head each re-read the context (from L2 after the first).  Simple
// and right first; wgmma, TMA and split-context parallelism are later
// work.  Exponentials use expf (no fast-math) so results hold the f32
// tolerance against the plain PyTorch version.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------
// decode: one query per slot against cache rows [0, pos[c]]
// ---------------------------------------------------------------------
constexpr int kDecodeThreads = 128;          // 4 warps
constexpr int kDecodeAcc = 2;                // D <= kDecodeThreads * kDecodeAcc

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const int* __restrict__ table,
                    const int* __restrict__ pos, TQ* __restrict__ out, int H,
                    int D, int bs, int M, float scale) {
  const int h = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kDecodeThreads / 32;
  extern __shared__ float smem[];
  float* qs = smem;          // D scaled query values
  float* ps = qs + D;        // bs scores, then probabilities

  const int p = pos[c];
  TQ* o = out + ((size_t)c * H + h) * D;
  if (p < 0) {               // inactive slot: exact zeros, nothing read
    for (int d = tid; d < D; d += kDecodeThreads) o[d] = from_f32<TQ>(0.f);
    return;
  }
  const TQ* qv = q + ((size_t)c * H + h) * D;
  for (int d = tid; d < D; d += kDecodeThreads) qs[d] = to_f32(qv[d]) * scale;
  __syncthreads();

  const size_t row_stride = (size_t)H * D;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[kDecodeAcc];
#pragma unroll
  for (int i = 0; i < kDecodeAcc; ++i) acc[i] = 0.f;

  // blocks past pos are skipped; a pos beyond the table attends the
  // table's M blocks, as the TPU kernel's (C, M) grid does
  const int nblk = min(p / bs + 1, M);
  for (int m = 0; m < nblk; ++m) {
    const int blk = table[(size_t)c * M + m];
    const int rows = min(bs, p + 1 - m * bs);
    const TKV* kb = kc + (size_t)blk * bs * row_stride + (size_t)h * D;
    const TKV* vb = vc + (size_t)blk * bs * row_stride + (size_t)h * D;
    for (int r = warp; r < rows; r += nwarps) {
      const TKV* kr = kb + (size_t)r * row_stride;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[d] * to_f32(kr[d]);
      s = warp_sum(s);
      if (lane == 0) ps[r] = s;
    }
    __syncthreads();
    float mx = m_run;
    for (int r = 0; r < rows; ++r) mx = fmaxf(mx, ps[r]);
    __syncthreads();         // every thread has read the raw scores
    if (tid < rows) ps[tid] = expf(ps[tid] - mx);
    __syncthreads();
    const float alpha = expf(m_run - mx);
    float lsum = 0.f;
    for (int r = 0; r < rows; ++r) lsum += ps[r];
    l_run = l_run * alpha + lsum;
    m_run = mx;
#pragma unroll
    for (int i = 0; i < kDecodeAcc; ++i) {
      const int d = tid + i * kDecodeThreads;
      if (d < D) {
        float a = acc[i] * alpha;
        for (int r = 0; r < rows; ++r) a += ps[r] * to_f32(vb[(size_t)r * row_stride + d]);
        acc[i] = a;
      }
    }
    __syncthreads();         // probabilities consumed before the next block
  }
  const float inv = 1.f / (l_run > 0.f ? l_run : 1.f);
#pragma unroll
  for (int i = 0; i < kDecodeAcc; ++i) {
    const int d = tid + i * kDecodeThreads;
    if (d < D) o[d] = from_f32<TQ>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------------
// chunked prefill: a K-row chunk at [start, start + len) over the cache
// ---------------------------------------------------------------------
constexpr int kChunkThreads = 256;
constexpr int kTileKeys = 32;
constexpr int kQueryRows = 8;                 // chunk rows per thread block

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_prefill_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                           const TQ* __restrict__ v, TKV* __restrict__ kc,
                           TKV* __restrict__ vc, const int* __restrict__ table,
                           const int* __restrict__ start,
                           const int* __restrict__ lens, TQ* __restrict__ out,
                           int K, int H, int D, int bs, int M, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // this block's chunk rows [i0, i1); the real ones are [i0, ie)
  const int i0 = blockIdx.z * kQueryRows, i1 = min(i0 + kQueryRows, K);
  const int st = start[b];
  // rows past K, or past the table's M * bs rows, are never touched
  const int L = max(0, min(min(lens[b], K), M * bs - st));
  const int ie = min(i1, L), nq = ie - i0;
  const size_t rs = (size_t)H * D;               // row stride
  const TQ* qb = q + (size_t)b * K * rs + (size_t)h * D;
  const TQ* kb = k + (size_t)b * K * rs + (size_t)h * D;
  const TQ* vb = v + (size_t)b * K * rs + (size_t)h * D;
  TQ* ob = out + (size_t)b * K * rs + (size_t)h * D;
  const int* tb = table + (size_t)b * M;

  // padded rows (>= L) are don't-care: written as zeros
  const int iz = max(i0, L);
  for (int idx = tid; idx < (i1 - iz) * D; idx += kChunkThreads) {
    const int i = iz + idx / D, d = idx % D;
    ob[(size_t)i * rs + d] = from_f32<TQ>(0.f);
  }
  if (nq <= 0) return;   // len == 0: no table entry read, cache untouched

  // scatter this head's slice of this block's real rows into their cache
  // rows (table entries past the last real row are never dereferenced)
  for (int idx = tid; idx < nq * D; idx += kChunkThreads) {
    const int j = i0 + idx / D, d = idx % D;
    const int ap = st + j;
    const size_t row = (size_t)tb[ap / bs] * bs + ap % bs;
    kc[row * rs + (size_t)h * D + d] = from_f32<TKV>(to_f32(kb[(size_t)j * rs + d]));
    vc[row * rs + (size_t)h * D + d] = from_f32<TKV>(to_f32(vb[(size_t)j * rs + d]));
  }

  extern __shared__ float smem[];
  const int KS = D + 1;                          // padded key-tile stride
  float* qs = smem;                              // kQueryRows * D
  float* acc = qs + (size_t)kQueryRows * D;      // kQueryRows * D
  float* ks = acc + (size_t)kQueryRows * D;      // kTileKeys * KS
  float* vs = ks + (size_t)kTileKeys * KS;       // kTileKeys * D
  float* ss = vs + (size_t)kTileKeys * D;        // kQueryRows * kTileKeys
  float* m_s = ss + (size_t)kQueryRows * kTileKeys;
  float* l_s = m_s + kQueryRows;
  float* a_s = l_s + kQueryRows;

  for (int idx = tid; idx < nq * D; idx += kChunkThreads) {
    const int r = idx / D, d = idx % D;
    qs[idx] = to_f32(qb[(size_t)(i0 + r) * rs + d]) * scale;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < nq; r += kChunkThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int nk = st + ie;                        // keys [0, start + ie)
  for (int kt = 0; kt < nk; kt += kTileKeys) {
    __syncthreads();     // previous tile fully consumed (and init done)
    for (int idx = tid; idx < kTileKeys * D; idx += kChunkThreads) {
      const int j = idx / D, d = idx % D;
      const int kp = kt + j;
      float kval = 0.f, vval = 0.f;
      if (kp < st) {     // earlier context: read back through the table
        const size_t row = (size_t)tb[kp / bs] * bs + kp % bs;
        kval = to_f32(kc[row * rs + (size_t)h * D + d]);
        vval = to_f32(vc[row * rs + (size_t)h * D + d]);
      } else if (kp < nk) {   // in-chunk key, rounded to the cache type
        kval = to_f32(from_f32<TKV>(to_f32(kb[(size_t)(kp - st) * rs + d])));
        vval = to_f32(from_f32<TKV>(to_f32(vb[(size_t)(kp - st) * rs + d])));
      }
      ks[j * KS + d] = kval;
      vs[j * D + d] = vval;
    }
    __syncthreads();
    for (int idx = tid; idx < nq * kTileKeys; idx += kChunkThreads) {
      const int r = idx / kTileKeys, j = idx % kTileKeys;
      const int kp = kt + j;
      float s = -1e30f;  // finite fill, as the TPU kernel: never a NaN
      if (kp < nk && kp <= st + i0 + r) {
        const float* qr = qs + (size_t)r * D;
        const float* kr = ks + j * KS;
        s = 0.f;
        for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      }
      ss[idx] = s;
    }
    __syncthreads();
    for (int r = tid; r < nq; r += kChunkThreads) {
      float* sr = ss + (size_t)r * kTileKeys;
      float mx = m_s[r];
      for (int j = 0; j < kTileKeys; ++j) mx = fmaxf(mx, sr[j]);
      const float alpha = expf(m_s[r] - mx);
      float sum = 0.f;
      for (int j = 0; j < kTileKeys; ++j) {
        const float pj = expf(sr[j] - mx);
        sr[j] = pj;
        sum += pj;
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < nq * D; idx += kChunkThreads) {
      const int r = idx / D, d = idx % D;
      const float* pr = ss + (size_t)r * kTileKeys;
      float a = acc[idx] * a_s[r];
      for (int j = 0; j < kTileKeys; ++j) a += pr[j] * vs[j * D + d];
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * D; idx += kChunkThreads) {
    const int r = idx / D, d = idx % D;
    const float l = l_s[r];
    ob[(size_t)(i0 + r) * rs + d] = from_f32<TQ>(acc[idx] / (l > 0.f ? l : 1.f));
  }
}

template <typename TQ, typename TKV>
int launch_decode(const void* q, const void* kc, const void* vc, const void* table,
                  const void* pos, void* out, int C, int H, int D, int bs, int M,
                  float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(D + bs) * sizeof(float);
  paged_decode_kernel<TQ, TKV><<<dim3(H, C), kDecodeThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kc, (const TKV*)vc, (const int*)table,
      (const int*)pos, (TQ*)out, H, D, bs, M, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_chunk(const void* q, const void* k, const void* v, void* kc, void* vc,
                 const void* table, const void* start, const void* lens, void* out,
                 int B, int K, int H, int D, int bs, int M, float scale,
                 size_t smem, cudaStream_t stream) {
  auto fn = paged_chunk_prefill_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(H, B, (K + kQueryRows - 1) / kQueryRows), kChunkThreads, smem, stream>>>(
      (const TQ*)q, (const TQ*)k, (const TQ*)v, (TKV*)kc, (TKV*)vc,
      (const int*)table, (const int*)start, (const int*)lens, (TQ*)out, K, H, D,
      bs, M, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16
int mx_paged_decode(const void* q, const void* kc, const void* vc, const void* table,
                    const void* pos, void* out, int C, int H, int D, int bs, int M,
                    float scale, int q_dtype, int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_decode<float, float>(q, kc, vc, table, pos, out, C, H, D, bs, M, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_decode<float, __nv_bfloat16>(q, kc, vc, table, pos, out, C, H, D, bs, M, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_decode<__nv_bfloat16, float>(q, kc, vc, table, pos, out, C, H, D, bs, M, scale, s);
  return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, table, pos, out, C, H, D, bs, M, scale, s);
}

size_t mx_paged_chunk_prefill_smem(int D) {
  return ((size_t)2 * kQueryRows * D + (size_t)kTileKeys * (D + 1) +
          (size_t)kTileKeys * D + (size_t)kQueryRows * kTileKeys +
          3 * (size_t)kQueryRows) * sizeof(float);
}

int mx_paged_chunk_prefill(const void* q, const void* k, const void* v, void* kc,
                           void* vc, const void* table, const void* start,
                           const void* lens, void* out, int B, int K, int H, int D,
                           int bs, int M, float scale, int q_dtype, int kv_dtype,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = mx_paged_chunk_prefill_smem(D);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_chunk<float, float>(q, k, v, kc, vc, table, start, lens, out, B, K, H, D, bs, M, scale, smem, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_chunk<float, __nv_bfloat16>(q, k, v, kc, vc, table, start, lens, out, B, K, H, D, bs, M, scale, smem, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_chunk<__nv_bfloat16, float>(q, k, v, kc, vc, table, start, lens, out, B, K, H, D, bs, M, scale, smem, s);
  return launch_chunk<__nv_bfloat16, __nv_bfloat16>(q, k, v, kc, vc, table, start, lens, out, B, K, H, D, bs, M, scale, smem, s);
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
