// Paged-KV-cache attention kernels for Hopper (sm_90a), plain C interface.
//
// mx_paged_decode replaces mxnet_tpu/pallas/attention.py
// paged_decode_attend (_paged_decode_kernel); mx_paged_chunk_prefill
// replaces paged_chunk_prefill_attend (_paged_chunk_prefill_kernel);
// mx_paged_prefill replaces paged_prefill_attend
// (_paged_prefill_kernel).  All keep the JAX functions' layouts:
// caches (num_blocks, block_size, H, D), queries and chunk rows
// seq-major (.., H, D), block tables and positions int32.
//
// What bounds them on the H100: decode reads the K/V rows of every live
// context once, sum_c (pos_c + 1) * H * D * 2 * sizeof(cache) bytes,
// and does 2 flops per element read: far below the 295 flops/byte the
// card needs before compute limits, so it is bound by memory bytes, and
// only the bytes in flight matter (one query row a head: the tensor cores
// would not help).
// Decode: the TPU grid was (slot, table block), walked in order on one
// core with the softmax state carried in scratch from step to step.
// Here each slot's keys are split over a fixed number of ranges nr (the
// wrapper's plan, a function of the static shapes alone, never of the
// positions, which live on the device), evenly: each range takes about
// (pos + 1) / nr keys, worked out on the device from the position, so
// the blocks of a slot finish together whatever its length.  One block
// of 4 warps takes each (range, chunk of 32 N output columns, head,
// slot): 512 blocks at the served shape (4 ranges), not 128.  A warp takes
// 4 keys a step, its lanes reading each K and V row 16 bytes a lane (N =
// 4 f32 or 8 bf16 or f16 values: a row of 128 f32 is one load instruction
// of the warp), V's 4 loads issued with K's; scores are reduced by
// shuffles, the online softmax runs in registers from the finite -1e30
// (no barrier a table block), and the 4 warps combine in order in
// shared memory.  The ranges of a (slot, head) form one thread block
// cluster (at most 8 ranges, the portable size), and after
// cluster.sync() its rank 0 reads the others' partials through
// distributed shared memory in range order and writes the output: one
// launch, no workspace (a second, combine launch from a workspace ran
// slower in every case measured, and took more host time a call: PERF.md
// §6, PR 13).  No atomics: two runs
// give the same bits.  Exponentials use expf (no fast-math) so results
// hold the f32 tolerance against the plain PyTorch version; the output
// is rounded once to q's type.
//
// Chunked prefill (mx_paged_chunk_prefill): a chunk of K rows per batch
// row at absolute positions [start, start + len), each attending
// causally to the whole context so far (the cache below start, the
// chunk's own keys above), with the scatter of the chunk's real rows into
// the cache fused in.  It reads the cached context once and the chunk
// rows, 4 * H * D * (2 start + 4 len) bytes for f32, and does 4 H D
// flops per (query, key) pair: at the mixed step's 64-row chunk after 576
// cached rows it is bound by bytes once its products run on the tensor
// cores (about 12.6 MB, 0.0038 ms at 3.35 TB/s, against 0.0019 ms of
// split-TF32 products; on the CUDA cores its 319 MFLOP took 0.0048), and
// at the spec step's 5-row spans over long contexts even more so.  The
// query rows are few and the context is long, so the work is split over
// the keys: the keys [0, M bs) of a row fall into fixed ranges of KR keys
// (a multiple of 32; the wrapper's plan, a function of the static shapes
// alone), and one block takes each (query tile of 16 kW rows, key range,
// row and head, 128 output columns).  It runs the f32 flash forward of
// attention_f32.cuh over the range's keys gathered through the block
// table: a key tile of 32 rows is two table blocks at block size 16, each
// block's slice of a head bs rows of D contiguous floats, H D apart, so
// the tile stages by 16-byte cp.async copies; each warp takes 16 query
// rows (the mixed step's 64-row chunk makes 4 warps, a spec span of 5
// rows one warp, its rows at or past len masked); scores and P V run in
// split TF32 (three mma.sync m16n8k8 a product step), P kept in
// registers, K split once as it lands, V at each load.  The range's
// unnormalised accumulators and each row's running max and sum go to a
// workspace the wrapper allocates, and a second kernel combines a row's
// ranges in order (the port's two-stage deterministic cross-block sum: no
// atomics, two runs give the same bits) and writes the chunk's rows into
// the cache, a block a (row, head), after every read of it.  The grid and the workspace
// depend only on static shapes (B, K, H, D, M bs), never on start or len,
// which live on the device: reading them would be a hidden host sync, and
// the launch stays capturable in a CUDA graph.  Blocks past a row's
// context, or with no real row, exit at once.  The semantics are the TPU
// kernel's: in-chunk keys come from the chunk input rounded to the cache
// type; cache rows are read only below start, and only by the first
// launch; the scatter of each real row is written by exactly one block of
// the second (its row and head), disjoint from every read; padded rows are
// zeros; len == 0 reads no table entry and leaves the cache untouched;
// masked scores take the finite fill -1e30, never NaN; keys clamp at the
// table's M bs rows; a bf16 cache beside f32 rows is widened and split
// (its lo is 0).  bf16 q/k/v over bf16 caches, the bf16 serving path, and
// f16 q/k/v over f16 caches, the f16 one, run paged_chunk16_kernel
// instead: the same ranges, stages, masks and combine on the 16-bit tile
// of attention_bf16.cuh (one 16-bit mma for Q K^T and two, P's hi and lo
// halves, for P V: about a quarter of the split TF32 kernel's tensor-core
// cycles for the same f32-accurate sums).
//
// One-shot prefill (mx_paged_prefill): causal attention of a padded
// prompt batch q/k/v (B, S, H, D) over its own keys, with the scatter
// of each row's first lengths[b] K/V rows into the cache fused in.  It
// does 4 * B * H * D * S * (S + 1) / 2 f32 flops (two products over the
// causal triangle) on about 4 * B * S * H * D * 4 bytes: ~64 flops per
// byte at S = 1024, D = 128, so it is bound by operations, like the
// flash forward, whose tensor-core design (attention_f32.cuh: split-TF32
// mma.sync, a cp.async ring, P in registers) it runs over the seq-major
// input, rows H * D elements apart.  The TPU kernel gave each (row,
// table block) grid step the row's whole K/V in VMEM; here one block of
// 4 warps takes each (head and row, query tile of 64 rows, chunk of 128
// output columns), longest tiles first, and walks the key tiles up to
// its diagonal.  The keys come from the input, not from the cache, and
// keys at or past S do not exist (S is any length; no padding is
// materialised).  Each block first scatters its own query rows below
// min(lengths[b], S) of its own head and chunk into cache block
// table[b, row / bs], row row % bs: writes are disjoint, no block reads
// the cache or waits for another, and table entries past a row's last
// real block are never read.  The TPU kernel clamps those grid steps
// onto the last real block and re-emits its bytes; not writing there
// leaves the same cache.  No atomics: two runs give the same bits.
// bf16 q/k/v over f32 caches are widened to f32 as they are staged
// (element by element; a bf16 value's tf32 split has lo = 0) and the
// output rounded once.  bf16 q/k/v over bf16 caches, the bf16 serving
// path (ROADMAP B.5), and f16 over f16, the f16 one, run
// paged_prefill16_kernel: the same blocks and fused scatter (16 bytes a
// copy) on the 16-bit tile of attention_bf16.cuh.  In bf16 or f16 it
// moves 2 * B S H D * (4 + 2 lengths / (B S)) bytes, 201 MB at the served
// 8 x 1024 x 16 x 128 with every row real, and does 34.4 GFLOP: 0.060 ms
// at 3.35 TB/s against 0.035 ms at the dense 989 TFLOP/s (the same for
// either type), so it is bound by bytes once its products run on the
// tensor cores.
//
// Head_dim is tiled in all three, so the reference's head_dims run (it
// has no head_dim limit).  Decode gives each range one block per 32 N
// output columns; each block computes the whole q . k.  The chunk
// prefill and the one-shot prefill tile head_dim as the flash kernels
// do: chunks of 128 columns staged in turn for the scores, one block per
// chunk of output columns (which recomputes the scores); each block
// scatters its own chunk of the K/V rows.  Neither has a head_dim limit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_bf16.cuh"
#include "attention_f32.cuh"

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------
// decode: one query per slot against cache rows [0, pos[c]], the keys
// split over ranges
// ---------------------------------------------------------------------
constexpr int kDecWarps = 4;                 // warps a block
constexpr int kDecKeys = 4;                  // keys a warp takes a step
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStep = kDecWarps * kDecKeys;   // keys a block takes a step
constexpr int kDecCluster = 8;               // most ranges a cluster combines (portable size)

// 16 bytes of T widened to f32: N values
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* d) {
    d[0] = __uint_as_float(u.x);
    d[1] = __uint_as_float(u.y);
    d[2] = __uint_as_float(u.z);
    d[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* d) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // the low half is the lower column
      d[2 * i] = __uint_as_float(w[i] << 16);
      d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* d) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // the low half is the lower column
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
};

// columns [c, c + N) of a row widened to f32, straight-line code (no
// branch, so a warp's loads of several rows issue back to back): kVec,
// one 16-byte load (D % N == 0 and 16-byte aligned rows, so a vector
// never crosses D); else element by element, the columns past D reading
// column 0 and set to zero
template <bool kVec, typename T>
__device__ __forceinline__ void load_cols(float* d, const T* __restrict__ row, int c, int D) {
  constexpr int N = Vec16<T>::N;
  if constexpr (kVec) {
    Vec16<T>::widen(__ldg(reinterpret_cast<const uint4*>(row + c)), d);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float v = to_f32(row[c + e < D ? c + e : 0]);
      d[e] = c + e < D ? v : 0.f;
    }
  }
}

// One block per (key range: x, ranges fastest, then column chunk; head:
// y; slot: z); the nr ranges of a (column chunk, head, slot) form one
// thread block cluster.  Each warp takes the range's keys kDecKeys at a
// time, in turn with the other warps: its lanes read each key's K and V
// row 16 bytes a lane (a row of 128 f32 is one load instruction of the
// warp), V's loads issued with K's in straight-line code, the scores
// reduced by shuffles, an online softmax in registers from the finite
// -1e30 (an empty range never makes a NaN).  The four warps' results
// are combined in warp order in shared memory into the block's partial:
// its running max, its sum and the W = 32 N accumulators of its column
// chunk (N values a 16-byte load holds).  The scores read the whole of
// head_dim (q scaled, in shared memory); a block accumulates its chunk
// of V's columns only.  After cluster.sync() rank 0 combines the
// partials of the ranges holding a key, in range order (every thread
// the same max and sum, the columns spread over the block), and writes
// the output; a second cluster.sync() keeps the ranks' shared memory
// alive until it has read them.  Blocks whose range starts past the
// slot's position read nothing and only take part in the two barriers;
// an inactive slot's blocks all exit at once, rank 0 writing zeros.
template <typename TQ, typename TKV, bool kVec>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const int* __restrict__ table,
                    const int* __restrict__ pos, TQ* __restrict__ out, int D, int bs, int M,
                    int nr, float scale) {
  constexpr int N = Vec16<TKV>::N, W = 32 * N;
  const int rg = (int)blockIdx.x % nr, oc = (int)blockIdx.x / nr * W;
  const int h = blockIdx.y, H = gridDim.y, c = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ch = (size_t)c * H + h;
  const int p = pos[c];
  if (p < 0) {                 // inactive slot: exact zeros, nothing read
    if (rg == 0)
      for (int d = threadIdx.x; d < min(W, D - oc); d += kDecThreads)
        out[ch * D + oc + d] = from_f32<TQ>(0.f);
    return;
  }
  // keys [0, kend): a position past the table attends the table's M
  // blocks, as the TPU kernel's (C, M) grid does.  They split evenly over
  // the nr ranges, in whole warp steps (per keys a range, at most
  // decode_range_keys)
  const int kend = min(p + 1, M * bs);
  const int per = ((kend + nr - 1) / nr + kDecKeys - 1) / kDecKeys * kDecKeys;
  const int k0 = rg * per, k1 = min(k0 + per, kend);
  extern __shared__ float smem[];
  float* qs = smem;                              // D scaled query values
  float* wml = qs + ((D + 3) & ~3);              // the warps' maxima, then sums
  float* wacc = wml + 2 * kDecWarps;             // the warps' accumulators, W each
  float* bp = wacc + kDecWarps * W;              // the block's max, sum, W accumulators
  int* tbs = reinterpret_cast<int*>(bp + 4 + W); // the range's table entries
  const int e0 = k0 / bs;
  if (k0 < k1) {
    const TQ* qv = q + ch * D;
    for (int d = threadIdx.x; d < D; d += kDecThreads) qs[d] = to_f32(qv[d]) * scale;
    const int ne = (k1 - 1) / bs - e0 + 1;       // entries past the context never read
    for (int e = threadIdx.x; e < ne; e += kDecThreads) tbs[e] = table[(size_t)c * M + e0 + e];
  }
  __syncthreads();

  const size_t rs = (size_t)H * D, hd = (size_t)h * D;   // row stride, head offset
  const int nvec = (D + N - 1) / N;              // N-column vectors in a row
  // this lane's vector of V (lanes past the row read its first vector)
  const int ov = oc / N + lane < nvec ? oc / N + lane : 0;
  float m = -1e30f, l = 0.f, acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int t0 = k0 + warp * kDecKeys; t0 < k1; t0 += kDecStep) {
    // the step's rows; a key past the range reads the range's last key
    // and is masked (its value set to zero, its score to the fill)
    size_t off[kDecKeys];
#pragma unroll
    for (int i = 0; i < kDecKeys; ++i) {
      const int kp = min(t0 + i, k1 - 1);
      off[i] = ((size_t)tbs[kp / bs - e0] * bs + kp % bs) * rs + hd;
    }
    float vv[kDecKeys][N];                       // V first: its loads fly with K's
#pragma unroll
    for (int i = 0; i < kDecKeys; ++i) load_cols<kVec>(vv[i], vc + off[i], ov * N, D);
    float s[kDecKeys];
#pragma unroll
    for (int i = 0; i < kDecKeys; ++i) s[i] = 0.f;
    for (int cv = lane; cv < nvec; cv += 32) {   // one pass when D <= W
      float qq[N];
#pragma unroll
      for (int e = 0; e < N; ++e) qq[e] = cv * N + e < D ? qs[cv * N + e] : 0.f;
#pragma unroll
      for (int i = 0; i < kDecKeys; ++i) {
        float kk[N];
        load_cols<kVec>(kk, kc + off[i], cv * N, D);
#pragma unroll
        for (int e = 0; e < N; ++e) s[i] += qq[e] * kk[e];
      }
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kDecKeys; ++i) {
      s[i] = warp_sum(s[i]);                     // the same bits in every lane
      if (t0 + i >= k1) s[i] = -1e30f;
      mx = fmaxf(mx, s[i]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] *= alpha;
    const bool live = oc / N + lane < nvec;      // lanes past the row add nothing
#pragma unroll
    for (int i = 0; i < kDecKeys; ++i) {
      const float pr = expf(s[i] - mx);          // 0 for a masked key
      l += pr;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += live && t0 + i < k1 ? pr * vv[i][e] : 0.f;
    }
    m = mx;
  }
  // the block's partial: the warps' results combined in warp order
  if (lane == 0) {
    wml[warp] = m;
    wml[kDecWarps + warp] = l;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) wacc[warp * W + lane * N + e] = acc[e];
  __syncthreads();
  float bm = -1e30f, wt[kDecWarps];
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) bm = fmaxf(bm, wml[w]);
  float bl = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    wt[w] = expf(wml[w] - bm);
    bl += wml[kDecWarps + w] * wt[w];
  }
  if (threadIdx.x == 0) {
    bp[0] = bm;
    bp[1] = bl;
  }
  for (int j = threadIdx.x; j < W; j += kDecThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) a += wacc[w * W + j] * wt[w];
    bp[2 + j] = a;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();                                // every rank's partial is written
  if (rg == 0) {
    // the ranges holding a key (range 0 always does, so the sum is
    // positive), in range order
    const int n = (kend - 1) / per + 1;
    float gm = -1e30f;
    for (int j = 0; j < n; ++j) gm = fmaxf(gm, cluster.map_shared_rank(bp, j)[0]);
    float lsum = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* r = cluster.map_shared_rank(bp, j);
      lsum += r[1] * expf(r[0] - gm);
    }
    const float inv = 1.f / lsum;
    for (int d = threadIdx.x; d < min(W, D - oc); d += kDecThreads) {
      float a = 0.f;
      for (int j = 0; j < n; ++j) {
        const float* r = cluster.map_shared_rank(bp, j);
        a += r[2 + d] * expf(r[0] - gm);
      }
      out[ch * D + oc + d] = from_f32<TQ>(a * inv);
    }
  }
  cluster.sync();                                // rank 0 has read them all
}

// the most keys a range takes: the table's M bs keys split over nr
// ranges in whole warp steps
int decode_range_keys(int ctx, int nr) {
  return ((ctx + nr - 1) / nr + kDecKeys - 1) / kDecKeys * kDecKeys;
}

// dynamic shared memory of the decode kernel, bytes: q, the warps' and
// the block's partials, the range's table entries (at most keys / bs + 2)
size_t decode_smem(int D, int keys, int bs, int N) {
  const int W = 32 * N;
  return sizeof(float) * (((D + 3) & ~3) + 2 * kDecWarps + kDecWarps * W + 4 + W) +
         sizeof(int) * (keys / bs + 2);
}

// ---------------------------------------------------------------------
// chunked prefill: a K-row chunk at [start, start + len) over the cache
// ---------------------------------------------------------------------
// keys a stage, stages of the ring (tools/torch_flash_tune.py --chunk
// times variants of these)
constexpr int kChunkStep = 32, kChunkStages = 2;
constexpr int kCombineThreads = 128;

// Stage key (or value) rows [k0, k0 + R) of one head, columns [c0, c0 +
// w), into an (R, kLd) f32 tile: keys below st from the cache through the
// table (tbs: the block's table entries from entry e0 on, in shared
// memory; cache rows rs elements apart, the head at hd), keys in [st,
// kend) from the chunk input rounded to the cache type, zeros from kend
// on and in columns [w, w rounded up to 8).  Each thread stages the
// elements attn32::stage_tile<R, TH> gives it, so attn32::split_tile
// splits them.
// vec: 16-byte cp.async (f32 input and cache, D % 4 == 0, 16-byte aligned
// bases); else element by element, made visible by the __syncthreads
// that starts the stage which reads the tile.
template <int R, int TH, typename TQ, typename TKV>
__device__ __forceinline__ void stage_keys(float* dst, const TKV* __restrict__ cache,
                                           const TQ* __restrict__ chunk,
                                           const int* tbs, int e0, int k0, int st, int kend,
                                           int bs, size_t rs, size_t hd, int c0, int w,
                                           bool vec) {
  const int wp = (w + 7) & ~7;
  const int l32 = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += TH / 32) {
    const int kp = k0 + r;
    const bool ok = kp < kend, in_cache = kp < st;
    // column c0 of the key's row: the cache's (head offset included) or
    // the chunk's (whose base carries the head)
    const size_t off = !ok ? 0
                       : in_cache ? ((size_t)tbs[kp / bs - e0] * bs + kp % bs) * rs + hd + c0
                                  : (size_t)(kp - st) * rs + c0;
    if constexpr (sizeof(TQ) == 4 && sizeof(TKV) == 4) {
      if (vec) {
        const int c = l32 * 4;
        if (c < wp) {
          const bool cok = ok && c < w;
          const void* src = in_cache ? (const void*)(cache + off + c)
                                     : (const void*)(chunk + off + c);
          tc::cp_async16(dst + r * attn32::kLd + c, cok ? src : (const void*)chunk, cok);
        }
        continue;
      }
    }
    for (int c = l32; c < wp; c += 32) {
      float val = 0.f;
      if (ok && c < w)
        val = in_cache ? to_f32(cache[off + c]) : to_f32(from_f32<TKV>(to_f32(chunk[off + c])));
      dst[r * attn32::kLd + c] = val;
    }
  }
}

// First stage: one block per (query tile of 16 kW chunk rows, range of KR
// keys; the grid's x, ranges fastest), (row, head) (y) and 128 output
// columns (z).  It attends its tile's rows to its range's keys in split
// TF32 on the tensor cores, the online softmax of attn32::forward with
// scores past a row's position masked to the finite -1e30, and writes
// the range's unnormalised accumulators to part (B H, nr, K, D) and each
// row's running max and sum to ml (B H, nr, K, 2).  The
// range's table entries are read once into shared memory, so a stage's
// copies wait on no table read.  A block with no real row or no key
// exits at once.
template <int kW, bool kFull, typename TQ, typename TKV>
__global__ void __launch_bounds__(32 * kW)
paged_chunk_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k, const TQ* __restrict__ v,
                   const TKV* __restrict__ kc, const TKV* __restrict__ vc,
                   const int* __restrict__ table,
                   const int* __restrict__ start, const int* __restrict__ lens,
                   float* __restrict__ part, float* __restrict__ ml, int K, int H, int D,
                   int bs, int M, int KR, int nr, float scale, int vec, int vecq) {
  using attn32::kDC;
  using attn32::kLd;
  constexpr int R = 16 * kW, TH = 32 * kW, KT = kChunkStep, NS = kChunkStages;
  constexpr int kQSlot = R * kLd, kKSlot = KT * kLd;    // a ring slot: 2 kKSlot
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rg = (int)blockIdx.x % nr, q0 = (int)blockIdx.x / nr * R;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const int st = start[b];
  // rows past K, or past the table's M * bs rows, are never touched
  const int L = max(0, min(min(lens[b], K), M * bs - st));
  const int ie = min(q0 + R, L);                 // the tile's real rows [q0, ie)
  const int k0 = rg * KR;
  if (q0 >= ie || k0 >= st + ie) return;
  const int k1 = min(k0 + KR, st + ie);          // this block's keys [k0, k1)
  const size_t rs = (size_t)H * D, hd = (size_t)h * D;   // row stride, head offset
  const size_t cb = (size_t)b * K * rs + hd;
  const TQ* qb = q + cb;
  const TQ* kb = k + cb;
  const TQ* vb = v + cb;
  const int* tb = table + (size_t)b * M;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  extern __shared__ float smem[];
  const int nch = (D + kDC - 1) / kDC;
  float* ring = smem;
  float* qs = ring + NS * 2 * kKSlot;
  // the table entries of the range's cached keys [k0, min(k1, st))
  int* tbs = reinterpret_cast<int*>(qs + (nch > 1 ? NS : 1) * kQSlot);
  const int e0 = k0 / bs, ne = k0 < st ? (min(k1, st) - 1) / bs - e0 + 1 : 0;
  for (int e = threadIdx.x; e < ne; e += TH) tbs[e] = tb[e0 + e];
  const int nkt = (k1 - k0 + KT - 1) / KT;
  const int per = nch + 1, nst = nkt * per;
  // stages per key tile: one per head_dim chunk of Q K^T (K's chunk, and
  // Q's when D > 128, else Q is resident), then one of P V
  auto issue = [&](int i) {
    const int kt = i / per, j = i - kt * per, buf = i % NS;
    float* tile = ring + buf * 2 * kKSlot;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) attn32::stage_tile<R, TH>(qs + buf * kQSlot, qb, q0, K, rs, c0, w, vecq);
      stage_keys<KT, TH>(tile, kc, kb, tbs, e0, k0 + kt * KT, st, k1, bs, rs, hd, c0, w, vec);
    } else {
      stage_keys<KT, TH>(tile, vc, vb, tbs, e0, k0 + kt * KT, st, k1, bs, rs, hd, oc0, ow, vec);
    }
  };
  if (nch == 1) attn32::stage_tile<R, TH>(qs, qb, q0, K, rs, 0, D, vecq);
  __syncthreads();                                  // the table entries landed
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }

  float sc[KT / 8][4], acc[kDC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  attn32::zero<kDC / 8>(acc);
  for (int i = 0; i < nst; ++i) {
    const int kt = i / per, j = i - kt * per, buf = i % NS;
    float* tile = ring + buf * 2 * kKSlot;
    tc::cp_async_wait<NS - 2>();
    if (j < nch) attn32::split_tile<KT, TH>(tile, tile + kKSlot, min(kDC, D - j * kDC), vec);
    __syncthreads();                                // stage i landed, i - 1 done
    if (i + NS - 1 < nst) issue(i + NS - 1);
    tc::cp_async_commit();
    if (j < nch) {                                  // S += Q_j K_j^T
      if (j == 0) attn32::zero<KT / 8>(sc);
      attn32::mma_nk<KT / 8>(sc, qs + (nch > 1 ? buf : 0) * kQSlot, warp * 16, tile,
                             tile + kKSlot, attn32::ksteps<kFull>(min(kDC, D - j * kDC)));
      continue;
    }
    // online softmax; keys past the row's position take the finite
    // fill, as the TPU kernel's, never a NaN (a tile never crosses the
    // range's end, KR being a multiple of KT, and keys past the context
    // are past every real row's position)
    const int kb0 = k0 + kt * KT;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = kb0 + nt * 8 + 2 * t + (e & 1);
        float x = sc[nt][e] * scale;
        if (c > st + r) x = -1e30f;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = attn32::quad_max(mx[hh]);
      alpha[hh] = expf(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    attn32::mma_kn<KT / 8, true>(acc, sc, tile, nullptr, attn32::ksteps<kFull>(ow));  // O += P V
  }
  tc::cp_async_wait<0>();
  // the range's partial results, rows past K left out
  const int row0 = q0 + warp * 16;
  const size_t pr = ((size_t)bh * nr + rg) * K;  // row 0 of this range
  const float one[2] = {1.f, 1.f};
  attn32::store_rows(part + pr * D, acc, row0, K, (size_t)D, oc0, ow, one);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = attn32::quad_sum(l[hh]);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + g + 8 * hh;
      if (r < K) {
        ml[(pr + r) * 2] = m[hh];
        ml[(pr + r) * 2 + 1] = l[hh];
      }
    }
  }
}

// Second stage: one block per (chunk row i, (row, head)) combines the
// row's ranges in order, those holding one of its keys ((st + i) / KR +
// 1 of them), into the output, and writes the row's K/V slice of this
// head into the cache: the fused scatter, each real row's slice by
// exactly one block, after every read of the cache (the first stage's,
// earlier on the stream).  Rows at or past the row's length are written
// as zeros and scatter nothing; table entries past the last real row
// are never read.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kCombineThreads)
paged_chunk_combine_kernel(const float* __restrict__ part, const float* __restrict__ ml,
                           const TQ* __restrict__ k, const TQ* __restrict__ v,
                           TKV* __restrict__ kc, TKV* __restrict__ vc,
                           const int* __restrict__ table, const int* __restrict__ start,
                           const int* __restrict__ lens, TQ* __restrict__ out, int K, int H,
                           int D, int bs, int M, int KR, int nr) {
  extern __shared__ float wts[];                 // a weight, then a sum, per range
  const int i = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int st = start[b];
  const int L = max(0, min(min(lens[b], K), M * bs - st));
  TQ* o = out + ((size_t)b * K + i) * H * D + (size_t)h * D;
  if (i >= L) {                                 // padding: don't-care, written as zeros
    for (int d = threadIdx.x; d < D; d += kCombineThreads) o[d] = from_f32<TQ>(0.f);
    return;
  }
  const size_t rs = (size_t)H * D, src = ((size_t)b * K + i) * rs + (size_t)h * D;
  const int ap = st + i;
  const size_t dst = ((size_t)table[(size_t)b * M + ap / bs] * bs + ap % bs) * rs + (size_t)h * D;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    kc[dst + d] = from_f32<TKV>(to_f32(k[src + d]));
    vc[dst + d] = from_f32<TKV>(to_f32(v[src + d]));
  }
  const int n = (st + i) / KR + 1;
  const size_t r0 = (size_t)bh * nr * K + i;    // row i of range 0; range j at r0 + j K
  // the ranges' maxima and sums, read in parallel, then each range's
  // weight exp(m_j - max)
  float* sums = wts + nr;
  for (int j = threadIdx.x; j < n; j += kCombineThreads) {
    wts[j] = ml[(r0 + (size_t)j * K) * 2];
    sums[j] = ml[(r0 + (size_t)j * K) * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = 0; j < n; ++j) mx = fmaxf(mx, wts[j]);
  __syncthreads();                              // every thread has the max
  for (int j = threadIdx.x; j < n; j += kCombineThreads) wts[j] = expf(wts[j] - mx);
  __syncthreads();
  float lsum = 0.f;
  for (int j = 0; j < n; ++j) lsum += sums[j] * wts[j];
  const float inv = 1.f / lsum;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) a += part[(r0 + (size_t)j * K) * D + d] * wts[j];
    o[d] = from_f32<TQ>(a * inv);
  }
}

// dynamic shared memory of the first stage, bytes: a ring of split K/V
// tiles (hi, then lo), the query tile (a ring when D > 128), then the
// range's table entries (at most KR / bs + 2)
size_t chunk_smem(int warps, int D, int KR, int bs) {
  return sizeof(float) * attn32::kLd *
             (kChunkStages * 2 * kChunkStep + 16 * warps * (D > attn32::kDC ? kChunkStages : 1)) +
         sizeof(int) * (KR / bs + 2);
}

// ---------------------------------------------------------------------
// one-shot prefill: causal attention over q/k/v (B, S, H, D) plus the
// scatter of rows < lengths[b] into the cache
// ---------------------------------------------------------------------
template <typename TQ, typename TKV, bool kFull>
__global__ void __launch_bounds__(32 * attn32::kFwdWarps, attn32::kFwdMinBlocks)
paged_prefill_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                     const TQ* __restrict__ v, TKV* __restrict__ kc,
                     TKV* __restrict__ vc, const int* __restrict__ table,
                     const int* __restrict__ lens, TQ* __restrict__ out, int S,
                     int H, int D, int bs, int M, float scale, int vec) {
  constexpr int R = 16 * attn32::kFwdWarps, TH = 32 * attn32::kFwdWarps;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int qt = (S + R - 1) / R - 1 - (int)blockIdx.y;    // longest rows first
  const int oc0 = blockIdx.z * attn32::kDC, ow = min(attn32::kDC, D - oc0);
  const size_t rs = (size_t)H * D;                        // row stride
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const TQ* kg = k + base;
  const TQ* vg = v + base;
  const int q0 = qt * R;

  // fused scatter: this block's rows below the row's length, this head
  // and this chunk of head_dim only, a warp a row; rows past the table's
  // M * bs rows are never written
  const int L = max(0, min(min(lens[b], S), M * bs));
  const int* tb = table + (size_t)b * M;
  for (int r = q0 + (threadIdx.x >> 5); r < min(q0 + R, L); r += TH / 32) {
    const size_t dst = ((size_t)tb[r / bs] * bs + r % bs) * rs + (size_t)h * D;
    for (int d = oc0 + (threadIdx.x & 31); d < oc0 + ow; d += 32) {
      kc[dst + d] = from_f32<TKV>(to_f32(kg[(size_t)r * rs + d]));
      vc[dst + d] = from_f32<TKV>(to_f32(vg[(size_t)r * rs + d]));
    }
  }

  extern __shared__ float smem[];
  attn32::forward<kFull>(q + base, kg, vg, out + base, nullptr, S, D, rs, qt, oc0, scale,
                         vec, smem);
}

// ---------------------------------------------------------------------
// 16-bit q/k/v over caches of the same type (bf16/bf16, the bf16 serving
// path; f16/f16, the f16 one): the one-shot and chunked prefills on the
// 16-bit tile of attention_bf16.cuh (exact Q K^T products, P V in hi and
// lo halves, P scaled by 2^12 in f16), the other type pairs keeping the
// split-TF32 kernels above
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// 16 bytes (8 values) at a time from src to dst when vec, else element by
// element: columns [c0, c0 + w) of one row
template <typename T>
__device__ __forceinline__ void copy_row16(T* __restrict__ dst, const T* __restrict__ src, int w,
                                           int lane, int lanes, bool vec) {
  if (vec) {
    for (int c = lane * 8; c < w; c += lanes * 8)
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(src + c);
  } else {
    for (int c = lane; c < w; c += lanes) dst[c] = src[c];
  }
}

// One block: (head and row: x, query tile of 64 rows counting down: y,
// 128 output columns: z), as paged_prefill_kernel, with the fused scatter
// of its rows below min(lengths[b], S), 16 bytes a copy when vec
template <typename T, bool kFull>
__global__ void __launch_bounds__(32 * attn16::kFwdWarps, attn16::kFwdMinBlocks)
paged_prefill16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ kc, T* __restrict__ vc,
                       const int* __restrict__ table, const int* __restrict__ lens,
                       T* __restrict__ out, int S, int H, int D, int bs, int M, float scale,
                       int vec) {
  constexpr int R = 16 * attn16::kFwdWarps, TH = 32 * attn16::kFwdWarps;
  const int b = (int)blockIdx.x / H, h = (int)blockIdx.x % H;
  const int qt = (S + R - 1) / R - 1 - (int)blockIdx.y;    // longest rows first
  const int oc0 = blockIdx.z * attn16::kDC, ow = min(attn16::kDC, D - oc0);
  const size_t rs = (size_t)H * D;                        // row stride
  const size_t base = (size_t)b * S * rs + (size_t)h * D;
  const int q0 = qt * R;
  const int L = max(0, min(min(lens[b], S), M * bs));
  const int* tb = table + (size_t)b * M;
  // a row's chunk is 16 lanes of 16 bytes at ow = 128: two rows a warp
  constexpr int kLanes = 16;
  for (int r = q0 + (int)threadIdx.x / kLanes; r < min(q0 + R, L); r += TH / kLanes) {
    const size_t src = base + (size_t)r * rs + oc0;
    const size_t dst = ((size_t)tb[r / bs] * bs + r % bs) * rs + (size_t)h * D + oc0;
    copy_row16(kc + dst, k + src, ow, threadIdx.x % kLanes, kLanes, vec);
    copy_row16(vc + dst, v + src, ow, threadIdx.x % kLanes, kLanes, vec);
  }
  extern __shared__ __align__(16) unsigned char smem16[];
  attn16::forward<kFull>(q + base, k + base, v + base, out + base, S, D, rs, qt, oc0, scale,
                         vec, reinterpret_cast<T*>(smem16));
}

// Stage key (or value) rows [k0, k0 + R) of one head, columns [c0, c0 +
// w), into an (R, kLds) tile of T: keys below st from the cache through
// the table (tbs, as stage_keys), keys in [st, kend) from the chunk input,
// zeros from kend on and in columns [w, w rounded up to 16).  vec:
// 16-byte cp.async (D % 8 == 0, 16-byte aligned bases); else element by
// element, made visible by the __syncthreads that starts the stage which
// reads the tile.
template <int R, int TH, typename T>
__device__ __forceinline__ void stage_keys16(T* dst, const T* __restrict__ cache,
                                             const T* __restrict__ chunk, const int* tbs, int e0,
                                             int k0, int st, int kend, int bs, size_t rs,
                                             size_t hd, int c0, int w, bool vec) {
  const int wp = (w + 15) & ~15;
  const int l16 = threadIdx.x & 15;
  for (int r = threadIdx.x >> 4; r < R; r += TH / 16) {
    const int kp = k0 + r;
    const bool ok = kp < kend;
    const T* src = !ok ? chunk
                   : kp < st ? cache + ((size_t)tbs[kp / bs - e0] * bs + kp % bs) * rs + hd + c0
                             : chunk + (size_t)(kp - st) * rs + c0;
    if (vec) {
      const int c = l16 * 8;
      if (c < wp) {
        const bool cok = ok && c < w;
        tc::cp_async16(dst + r * attn16::kLds + c, cok ? src + c : chunk, cok);
      }
    } else {
      for (int c = l16; c < wp; c += 16)
        dst[r * attn16::kLds + c] = ok && c < w ? src[c] : tc::T16<T>::round(0.f);
    }
  }
}

// First stage of the chunked prefill in 16 bits: the blocks, ranges,
// stages, masks and workspace of paged_chunk_kernel, on the 16-bit tile.
// Running maxima go to ml in natural-log units (m ln 2), as the combine
// reads them; the partial sums are scaled back by p_unscale (exact).
template <typename T, int kW, bool kFull>
__global__ void __launch_bounds__(32 * kW)
paged_chunk16_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ kc, const T* __restrict__ vc,
                     const int* __restrict__ table, const int* __restrict__ start,
                     const int* __restrict__ lens, float* __restrict__ part,
                     float* __restrict__ ml, int K, int H, int D, int bs, int M, int KR, int nr,
                     float scale, int vec) {
  using attn16::kDC;
  using attn16::kLds;
  constexpr int R = 16 * kW, TH = 32 * kW, KT = kChunkStep, NS = kChunkStages;
  constexpr int kQSlot = R * kLds, kKSlot = KT * kLds;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rg = (int)blockIdx.x % nr, q0 = (int)blockIdx.x / nr * R;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const int st = start[b];
  // rows past K, or past the table's M * bs rows, are never touched
  const int L = max(0, min(min(lens[b], K), M * bs - st));
  const int ie = min(q0 + R, L);                 // the tile's real rows [q0, ie)
  const int k0 = rg * KR;
  if (q0 >= ie || k0 >= st + ie) return;
  const int k1 = min(k0 + KR, st + ie);          // this block's keys [k0, k1)
  const size_t rs = (size_t)H * D, hd = (size_t)h * D;
  const size_t cb = (size_t)b * K * rs + hd;
  const T* qb = q + cb;
  const T* kb = k + cb;
  const T* vb = v + cb;
  const int* tb = table + (size_t)b * M;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float sl2 = scale * attn16::kLog2e;

  extern __shared__ __align__(16) unsigned char smem16[];
  const int nch = (D + kDC - 1) / kDC;
  T* ring = reinterpret_cast<T*>(smem16);
  T* qs = ring + NS * kKSlot;
  int* tbs = reinterpret_cast<int*>(qs + (nch > 1 ? NS : 1) * kQSlot);
  const int e0 = k0 / bs, ne = k0 < st ? (min(k1, st) - 1) / bs - e0 + 1 : 0;
  for (int e = threadIdx.x; e < ne; e += TH) tbs[e] = tb[e0 + e];
  const int nkt = (k1 - k0 + KT - 1) / KT;
  const int per = nch + 1, nst = nkt * per;
  auto issue = [&](int i) {
    const int kt = i / per, j = i - kt * per, buf = i % NS;
    T* tile = ring + buf * kKSlot;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) attn16::stage_tile<R, TH>(qs + buf * kQSlot, qb, q0, K, rs, c0, w, vec);
      stage_keys16<KT, TH>(tile, kc, kb, tbs, e0, k0 + kt * KT, st, k1, bs, rs, hd, c0, w, vec);
    } else {
      stage_keys16<KT, TH>(tile, vc, vb, tbs, e0, k0 + kt * KT, st, k1, bs, rs, hd, oc0, ow,
                           vec);
    }
  };
  if (nch == 1) attn16::stage_tile<R, TH>(qs, qb, q0, K, rs, 0, D, vec);
  __syncthreads();                                  // the table entries landed
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }

  float sc[KT / 8][4], acc[kDC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  attn16::zero<kDC / 8>(acc);
  for (int i = 0; i < nst; ++i) {
    tc::cp_async_wait<NS - 2>();
    __syncthreads();                                // stage i landed, i - 1 done
    if (i + NS - 1 < nst) issue(i + NS - 1);
    tc::cp_async_commit();
    const int kt = i / per, j = i - kt * per, buf = i % NS;
    const T* tile = ring + buf * kKSlot;
    if (j < nch) {                                  // S += Q_j K_j^T
      if (j == 0) attn16::zero<KT / 8>(sc);
      attn16::mma_nk<KT / 8>(sc, qs + (nch > 1 ? buf : 0) * kQSlot, warp * 16, tile,
                             attn16::ksteps<kFull>(min(kDC, D - j * kDC)));
      continue;
    }
    // keys past the row's position take the finite fill, as the TPU
    // kernel's, never a NaN
    const int kb0 = k0 + kt * KT;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = kb0 + nt * 8 + 2 * t + (e & 1);
        const float x = sc[nt][e] * sl2;
        sc[nt][e] = c > st + r ? -1e30f : x;
      }
    attn16::softmax_step<KT / 8>(sc, m, l, acc);
    attn16::mma_kn<KT / 16>(acc, sc, tile, attn16::ksteps<kFull>(ow));  // O += (hi + lo) V
  }
  tc::cp_async_wait<0>();
  // the range's partial results, rows past K left out
  const int row0 = q0 + warp * 16;
  const size_t pr = ((size_t)bh * nr + rg) * K;  // row 0 of this range
  const float unscale[2] = {attn16::p_unscale<T>(), attn16::p_unscale<T>()};
  attn32::store_rows(part + pr * D, acc, row0, K, (size_t)D, oc0, ow, unscale);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = attn16::quad_sum(l[hh]);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + g + 8 * hh;
      if (r < K) {
        ml[(pr + r) * 2] = m[hh] * attn16::kLn2;
        ml[(pr + r) * 2 + 1] = l[hh];
      }
    }
  }
}

// dynamic shared memory of the 16-bit first stage, bytes: a ring of K/V
// tiles, the query tile (a ring when D > 128), then the range's table
// entries (at most KR / bs + 2); the same for both types
size_t chunk16_smem(int warps, int D, int KR, int bs) {
  return sizeof(bf16) * attn16::kLds *
             (kChunkStages * kChunkStep + 16 * warps * (D > attn16::kDC ? kChunkStages : 1)) +
         sizeof(int) * (KR / bs + 2);
}

// a kernel's dynamic shared memory past the 48 KB default needs the
// attribute set before the launch
template <typename F>
cudaError_t allow_smem(F fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_prefill16(const void* q, const void* k, const void* v, void* kc, void* vc,
                     const void* table, const void* lens, void* out, int B, int S, int H, int D,
                     int bs, int M, float scale, cudaStream_t stream) {
  const auto fn = D % attn16::kDC == 0 ? paged_prefill16_kernel<T, true>
                                       : paged_prefill16_kernel<T, false>;
  const size_t smem = attn16::fwd_smem(D);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(kc) && tc::aligned16(vc);
  fn<<<attn32::grid_of(B * H, S, D, attn16::kFwdWarps), 32 * attn16::kFwdWarps, smem,
       stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)kc, (T*)vc, (const int*)table,
                 (const int*)lens, (T*)out, S, H, D, bs, M, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk16(const void* q, const void* k, const void* v, void* kc, void* vc,
                   const void* table, const void* start, const void* lens, void* out,
                   float* part, float* ml, int B, int K, int H, int D, int bs, int M, int KR,
                   int warps, float scale, cudaStream_t stream) {
  const bool full = D % attn16::kDC == 0;
  const auto fn = warps == 1 ? (full ? paged_chunk16_kernel<T, 1, true>
                                     : paged_chunk16_kernel<T, 1, false>)
                             : (full ? paged_chunk16_kernel<T, 4, true>
                                     : paged_chunk16_kernel<T, 4, false>);
  const size_t smem = chunk16_smem(warps, D, KR, bs);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(kc) && tc::aligned16(vc);
  const int nr = (M * bs + KR - 1) / KR, qt = (K + 16 * warps - 1) / (16 * warps);
  fn<<<dim3(nr * qt, B * H, (D + attn16::kDC - 1) / attn16::kDC), 32 * warps, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)kc, (const T*)vc, (const int*)table,
      (const int*)start, (const int*)lens, part, ml, K, H, D, bs, M, KR, nr, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_chunk_combine_kernel<T, T><<<dim3(K, B * H), kCombineThreads, 2 * sizeof(float) * nr,
                                     stream>>>(
      part, ml, (const T*)k, (const T*)v, (T*)kc, (T*)vc, (const int*)table, (const int*)start,
      (const int*)lens, (T*)out, K, H, D, bs, M, KR, nr);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_prefill(const void* q, const void* k, const void* v, void* kc, void* vc,
                   const void* table, const void* lens, void* out, int B, int S, int H,
                   int D, int bs, int M, float scale, size_t smem, cudaStream_t stream) {
  const auto fn = D % attn32::kDC == 0 ? paged_prefill_kernel<TQ, TKV, true>
                                       : paged_prefill_kernel<TQ, TKV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies for f32 rows of D % 4 == 0 (the row stride H * D is
  // then a multiple of 4 too); bf16 inputs are widened element by element
  const int vec = sizeof(TQ) == 4 && D % 4 == 0 && tc::aligned16(q) && tc::aligned16(k) &&
                  tc::aligned16(v);
  fn<<<attn32::grid_of(B * H, S, D, attn32::kFwdWarps), 32 * attn32::kFwdWarps, smem,
       stream>>>((const TQ*)q, (const TQ*)k, (const TQ*)v, (TKV*)kc, (TKV*)vc,
                 (const int*)table, (const int*)lens, (TQ*)out, S, H, D, bs, M, scale, vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_decode(const void* q, const void* kc, const void* vc, const void* table,
                  const void* pos, void* out, int C, int H, int D, int bs, int M, int nr,
                  float scale, cudaStream_t stream) {
  constexpr int N = Vec16<TKV>::N;
  const int nz = (D + 32 * N - 1) / (32 * N);
  const size_t smem = decode_smem(D, decode_range_keys(M * bs, nr), bs, N);
  // 16-byte loads of K/V rows when every row starts 16-byte aligned
  const bool vec = D % N == 0 && tc::aligned16(kc) && tc::aligned16(vc);
  const auto fn = vec ? paged_decode_kernel<TQ, TKV, true> : paged_decode_kernel<TQ, TKV, false>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {      // past the default only at head_dims of thousands
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nr * nz, H, C);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nr;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, (const TQ*)q, (const TKV*)kc, (const TKV*)vc,
                           (const int*)table, (const int*)pos, (TQ*)out, D, bs, M, nr, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_chunk(const void* q, const void* k, const void* v, void* kc, void* vc,
                 const void* table, const void* start, const void* lens, void* out,
                 float* part, float* ml, int B, int K, int H, int D, int bs, int M, int KR,
                 int warps, float scale, cudaStream_t stream) {
  const bool full = D % attn32::kDC == 0;
  const auto fn = warps == 1 ? (full ? paged_chunk_kernel<1, true, TQ, TKV>
                                     : paged_chunk_kernel<1, false, TQ, TKV>)
                             : (full ? paged_chunk_kernel<4, true, TQ, TKV>
                                     : paged_chunk_kernel<4, false, TQ, TKV>);
  const size_t smem = chunk_smem(warps, D, KR, bs);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies for f32 rows of D % 4 == 0 (the row stride H * D is
  // then a multiple of 4 too); bf16 rows, and chunk keys rounded to a
  // bf16 cache, element by element
  const int vec = sizeof(TQ) == 4 && sizeof(TKV) == 4 && D % 4 == 0 && tc::aligned16(k) &&
                  tc::aligned16(v) && tc::aligned16(kc) && tc::aligned16(vc);
  const int vecq = sizeof(TQ) == 4 && D % 4 == 0 && tc::aligned16(q);
  const int nr = (M * bs + KR - 1) / KR, qt = (K + 16 * warps - 1) / (16 * warps);
  fn<<<dim3(nr * qt, B * H, (D + attn32::kDC - 1) / attn32::kDC), 32 * warps, smem,
       stream>>>((const TQ*)q, (const TQ*)k, (const TQ*)v, (const TKV*)kc, (const TKV*)vc,
                 (const int*)table, (const int*)start, (const int*)lens, part, ml, K, H, D,
                 bs, M, KR, nr, scale, vec, vecq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_chunk_combine_kernel<TQ, TKV><<<dim3(K, B * H), kCombineThreads,
                                        2 * sizeof(float) * nr, stream>>>(
      part, ml, (const TQ*)k, (const TQ*)v, (TKV*)kc, (TKV*)vc, (const int*)table,
      (const int*)start, (const int*)lens, (TQ*)out, K, H, D, bs, M, KR, nr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  Every (q, cache)
// pair has an explicit case: f32 and bf16 in any pairing, f16 only over
// f16 caches (the f16 serving path); any other pairing or an unknown code
// returns cudaErrorInvalidValue and launches nothing, never another
// type's kernel.
// ranges: the thread block cluster's size, 1 to 8; each slot's keys split
// evenly over them
int mx_paged_decode(const void* q, const void* kc, const void* vc, const void* table,
                    const void* pos, void* out, int C, int H, int D, int bs, int M, int ranges,
                    float scale, int q_dtype, int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ranges < 1 || ranges > kDecCluster) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_decode<float, float>(q, kc, vc, table, pos, out, C, H, D, bs, M, ranges, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_decode<float, __nv_bfloat16>(q, kc, vc, table, pos, out, C, H, D, bs, M, ranges, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_decode<__nv_bfloat16, float>(q, kc, vc, table, pos, out, C, H, D, bs, M, ranges, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, table, pos, out, C, H, D, bs, M, ranges, scale, s);
  if (q_dtype == 2 && kv_dtype == 2)
    return launch_decode<__half, __half>(q, kc, vc, table, pos, out, C, H, D, bs, M, ranges, scale, s);
  return (int)cudaErrorInvalidValue;
}

// 0 for a bad dtype code
size_t mx_paged_decode_smem(int D, int ctx, int bs, int ranges, int kv_dtype) {
  if (kv_dtype < 0 || kv_dtype > 2) return 0;
  return decode_smem(D, decode_range_keys(ctx, ranges), bs, kv_dtype == 0 ? 4 : 8);
}

// kind: 0 for the split-TF32 kernel, 1 for the 16-bit tile (bf16/bf16 and
// f16/f16 alike); 0 for any other kind
size_t mx_paged_chunk_prefill_smem(int warps, int D, int key_range, int bs, int kind) {
  return kind == 0   ? chunk_smem(warps, D, key_range, bs)
         : kind == 1 ? chunk16_smem(warps, D, key_range, bs)
                     : 0;
}

// q, k, v, out: (B, K, H, D) seq-major; start, lens (B,) int32; part
// (B H, nr, K, D) and ml (B H, nr, K, 2) f32 workspaces, nr = ceil(M bs
// / key_range); key_range a multiple of 32; warps 1 or 4
int mx_paged_chunk_prefill(const void* q, const void* k, const void* v, void* kc,
                           void* vc, const void* table, const void* start,
                           const void* lens, void* out, void* part, void* ml, int B, int K,
                           int H, int D, int bs, int M, int key_range, int warps, float scale,
                           int q_dtype, int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (key_range <= 0 || key_range % kChunkStep != 0 || (warps != 1 && warps != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pf = (float*)part;
  float* mf = (float*)ml;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_chunk<float, float>(q, k, v, kc, vc, table, start, lens, out, pf, mf, B, K, H, D, bs, M, key_range, warps, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_chunk<float, __nv_bfloat16>(q, k, v, kc, vc, table, start, lens, out, pf, mf, B, K, H, D, bs, M, key_range, warps, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_chunk<__nv_bfloat16, float>(q, k, v, kc, vc, table, start, lens, out, pf, mf, B, K, H, D, bs, M, key_range, warps, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_chunk16<__nv_bfloat16>(q, k, v, kc, vc, table, start, lens, out, pf, mf, B, K, H, D, bs, M, key_range, warps, scale, s);
  if (q_dtype == 2 && kv_dtype == 2)
    return launch_chunk16<__half>(q, k, v, kc, vc, table, start, lens, out, pf, mf, B, K, H, D, bs, M, key_range, warps, scale, s);
  return (int)cudaErrorInvalidValue;
}

// kind as for mx_paged_chunk_prefill_smem
size_t mx_paged_prefill_smem(int D, int kind) {
  return kind == 0 ? attn32::fwd_smem(D) : kind == 1 ? attn16::fwd_smem(D) : 0;
}

// q, k, v, out: (B, S, H, D) seq-major, any D; lengths (B,) int32
int mx_paged_prefill(const void* q, const void* k, const void* v, void* kc, void* vc,
                     const void* table, const void* lens, void* out, int B, int S, int H,
                     int D, int bs, int M, float scale, int q_dtype, int kv_dtype,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = attn32::fwd_smem(D);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_prefill<float, float>(q, k, v, kc, vc, table, lens, out, B, S, H, D, bs, M, scale, smem, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_prefill<float, __nv_bfloat16>(q, k, v, kc, vc, table, lens, out, B, S, H, D, bs, M, scale, smem, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_prefill<__nv_bfloat16, float>(q, k, v, kc, vc, table, lens, out, B, S, H, D, bs, M, scale, smem, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_prefill16<__nv_bfloat16>(q, k, v, kc, vc, table, lens, out, B, S, H, D, bs, M, scale, s);
  if (q_dtype == 2 && kv_dtype == 2)
    return launch_prefill16<__half>(q, k, v, kc, vc, table, lens, out, B, S, H, D, bs, M, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
