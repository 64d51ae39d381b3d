// The f32 fused BatchNorm-apply, ReLU and 1x1 convolution on Hopper's
// tensor cores (sm_90a), in split TF32: the f32 launches of
// fused_matmul.cu (TPU kernel row 7, mxnet_tpu/ops/fused.py _pallas_fwd)
// and of fused_band4d.cu (row 10, tools/fused_sandwich_bench.py
// pal4d_band):
//
//   Y[M, N] = relu(X[M, K] * scale[K] + shift[K]) @ W  (+ R[M, N])
//
// X's rows are read through four strides (b, h, w, k), as in
// fused_gemm_bf16.cuh: row 7 passes a contiguous (M, K) matrix as one
// image row of M pixels, row 10 its 4-D channel-last tensor as it is.  W
// is (N, K) row-major for row 7 (the OHWI weight as stored) and (K, N)
// for row 10 (W_KN); R (row 7 only) and Y are f32 and contiguous (M, N).
// The affine is computed as the plain versions compute it (__fmul_rn,
// then __fadd_rn), the ReLU passes NaN as torch.relu does, every product
// runs in split TF32 (tc_mma.cuh: hi = tf32(x), lo = x - hi, three
// mma.sync m16n8k8 a product step) and sums in f32, and the residual is
// added in f32.  Any M, K and N; nothing is padded.
//
// What bounds it on the H100: 2*M*N*K operations against 4 * (M*K + N*K
// + M*N (+ M*N)) bytes.  On the CUDA cores (67 TFLOP/s of f32 FMAs) six
// of ResNet-50's eight site shapes were bound by operations; at three
// dense TF32 products per f32-accurate product (494.7 / 3 TFLOP/s) the
// stage-1 and stage-2 sites and the residual sites are bound by bytes,
// the others by the tensor cores, and so are the fused sandwich's two
// bands (2.63e10 operations each, 0.161 ms).  The split is what the
// tensor cores pay for f32 accuracy: a TF32 product alone leaves the
// tolerance (rtol 1e-4 / atol 1e-5 against the plain f32 version) at K =
// 2048.
//
// Design: the main loop of fused_gemm_bf16.cuh in f32.  A block of 16
// warps, one block an SM (the split tiles take 144-148 KB of shared
// memory), computes one 128 x 128 tile of Y, each warp a 64 x 16 sub-tile
// of m16n8 f32 accumulators in registers (32 a thread, which with the
// fragments fits the 128 registers of 512 threads without a spill).  The
// tile is 128 x 64 (16 x 32 a warp) when N <= 64, and also when 128 x 128
// tiles would not make two waves over the card's 132 SMs (ResNet-50's
// 6272 x 2048 -> 512 site: 196 tiles, 392 narrow ones).  K is walked in
// stages of kStep columns through a cp.async ring of kStages stages; a
// stage holds X's hi and lo halves (128 rows) and W's, X's rows padded to
// kLd = kStep + 4 floats so the 8 row addresses of every ldmatrix fall on
// distinct bank groups; each row's offset in X is worked out once per
// block, into a table in shared memory.  Blocks walk N fastest, so the
// blocks that share a tile of X rows run together and read it from L2; a
// block with a residual first asks L2 for its residual tile
// (cp.async.bulk.prefetch.L2), so the epilogue's reads find it there.
// Measured against the alternatives (tools/torch_fused_tune.py --dtype
// float32, the 28 launches of a batch-128 ResNet-50 step on an H100):
// 8-warp blocks of 64 x 32 sub-tiles (216-228 registers, one block an
// SM) ran 3-18% slower, two 8-warp blocks an SM spilled, chains of 2 k8
// steps spilled at 16 warps, a ring of 3 gained under 1%.
//
// W (K, N).  ldmatrix has no transposing form for 32-bit elements, so
// W's (k, n) rows cannot reach the B fragments the way the bf16 GEMM's
// ldmatrix.trans takes them.  W's hi and lo stay (k, n) tiles with rows
// padded to BN + 8 floats, and each B fragment is two scalar shared
// loads (b0 = B[k = lane % 4][n = lane / 4], b1 at k + 4), free of bank
// conflicts at that padding.  On an H100 (700 W) at the fused sandwich's
// two f32 bands this took 0.6981 / 0.5713 ms, against 0.7562 / 0.6302
// for W's rows landing by cp.async in a tile of their own and written
// transposed, split, into the (n, k) tiles row 7 reads (37 KB more
// shared memory, and scalar transposed stores).  Each output's sum runs
// over the same k8 steps in the same groups as row 7's, so rows 7 and 10
// give the same bits on the same operands.
//
// The prologue and the split run once per element per block.  A thread
// copies the same 4-column chunk of K in every X row it stages, and the
// same W chunks in every stage.  After the products of stage st, once
// cp.async.wait_group says its copies of stage st + 1 have landed, it
// rewrites its X chunks in place (affine, ReLU, then split: hi over the
// f32 value, lo into the lo tile) and splits its W chunks the same way;
// the barrier that starts stage st + 1, which the ring needs anyway,
// publishes them.  No warp repeats another's prologue or split, and the
// fragment loads read stored halves.  Padding is zero AFTER the
// prologue: a zero-filled X element would become relu(shift), so rows
// past M and columns past K are written as zeros by the prologue itself.
// Zero-filled copies take the tensor's base as their source pointer,
// never an address past its end.  X stages by 16-byte cp.async when its
// channel stride is 1, K % 4 == 0 and every row, scale and shift are
// 16-byte aligned (VEC_X: a contiguous tensor, a channels_last view, an
// aligned channel slice); otherwise (an NHWC view of an NCHW tensor, K %
// 4 != 0, an unaligned pointer) each thread loads, transforms, splits and
// stores its elements one by one into the same stage, still on the
// tensor cores.  W and Y take the same choice at run time (vec_w, vec_y).
//
// Accumulation.  The tensor cores' f32 sums do not round to nearest, and
// a long chain of mma into one accumulator drifts (the f32 attention
// kernels' dQ left its tolerance over 1024 keys): each group of kGroup
// k8 steps (3 kGroup mma) sums into a fresh fragment, which an f32 add
// puts into the accumulator, so K = 2048 takes 2048 / (8 kGroup) rounded
// adds.  A warp loads W's fragments of a group once (kNT n8 tiles, hi and
// lo), then walks its m16 tiles, each one's A fragments loaded once.
//
// The epilogue stages the f32 accumulators through shared memory (rows
// padded by 8 floats, so the fragments' 8-byte stores are free of bank
// conflicts), then each thread reads the residual and writes Y in
// 16-byte vectors.  Determinism: no split over K and no atomics, so two
// runs give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_gemm_bf16.cuh"
#include "tc_mma.cuh"

namespace fused_gemm {
namespace f32 {

using tc::kSMs;
using tc::split_f;
using Args = GemmArgs<float>;

// K columns per stage, stages of the ring, blocks an SM (a register
// budget for ptxas), k8 steps an mma chain sums, warps a block
// (tools/torch_fused_tune.py --dtype float32 times variants of these)
constexpr int kStep = 32, kStages = 2, kMinBlocks = 1, kGroup = 4;
constexpr int kWarps = 16, kBM = 128;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kStep + 4;    // floats a shared-memory (m, k) or (n, k) row of a stage
constexpr int kCPR = kStep / 4;   // 16-byte chunks a row of a stage
constexpr int kCPad = 8;          // f32 of padding per row of the epilogue tile
static_assert(kStep % (8 * kGroup) == 0, "a stage is whole mma chains");
static_assert(kStages >= 2, "stage st + 1 is transformed while st is read");

template <int BN, bool W_KN>
struct Cfg {
  static constexpr int kWarpsM = kBM > BN ? kWarps / 2 : 2;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kWM = kBM / kWarpsM, kWN = BN / kWarpsN;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;    // m16 and n8 tiles a warp
  // W's hi and lo tiles are (n, k) rows of kLd floats, or, for W (K,
  // N), (k, n) rows of kLdw
  static constexpr int kLdw = BN + 8;
  static constexpr int kWTile = W_KN ? kStep * kLdw : BN * kLd;
  // a stage: X hi, X lo (kBM rows), W hi, W lo
  static constexpr int kStageFloats = 2 * kBM * kLd + 2 * kWTile;
  static constexpr int kAPer = kBM * kCPR / kThreads;     // X chunks a thread
  static constexpr int kBPer = BN * kCPR / kThreads;      // W chunks a thread
  static constexpr int kLdc = BN + kCPad;                 // the epilogue's f32 tile
  static constexpr size_t kRing = sizeof(float) * kStages * kStageFloats;
  // the row-offset table sits past both the ring and the epilogue's tile
  static constexpr size_t kRowOff =
      kRing > sizeof(float) * kBM * kLdc ? kRing : sizeof(float) * kBM * kLdc;
  static constexpr size_t kSmem = kRowOff + sizeof(int64_t) * kBM;
  static_assert(kMT >= 1 && kNT >= 2 && kNT % 2 == 0, "warp tile");
  static_assert(kAPer >= 1 && kBM * kCPR % kThreads == 0, "X chunks");
  static_assert(kBPer >= 1 && BN * kCPR % kThreads == 0, "W chunks");
  static_assert(kThreads % kCPR == 0, "a thread keeps one chunk column");
  static_assert(kThreads % (BN / 4) == 0, "a thread keeps its W (K, N) chunk columns");
};

// affine, ReLU and split of four X elements (rows past M, columns past K
// give zeros in both halves)
__device__ __forceinline__ void prologue4(float4& v, float4& lo, const float4& s,
                                          const float4& h) {
  split_f(affine_relu(v.x, s.x, h.x), v.x, lo.x);
  split_f(affine_relu(v.y, s.y, h.y), v.y, lo.y);
  split_f(affine_relu(v.z, s.z, h.z), v.z, lo.z);
  split_f(affine_relu(v.w, s.w, h.w), v.w, lo.w);
}
__device__ __forceinline__ void split4(float4& v, float4& lo) {
  split_f(v.x, v.x, lo.x);
  split_f(v.y, v.y, lo.y);
  split_f(v.z, v.z, lo.z);
  split_f(v.w, v.w, lo.w);
}

template <int BN, bool W_KN, bool VEC_X>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_gemm_f32_kernel(const Args p) {
  using C = Cfg<BN, W_KN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int64_t m0 = (int64_t)(blockIdx.x / p.tiles_n) * kBM;
  const int n0 = (int)(blockIdx.x % p.tiles_n) * BN;
  const int K = p.K, N = p.N;
  const int rows = (int)(p.M - m0 < kBM ? p.M - m0 : kBM);
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem + C::kRowOff);
  row_offsets<kBM, kThreads>(rowoff, p, m0, rows);

  // this thread's X chunks: column ck (4 elements of K) of rows ar0 + i *
  // kRowStep; its W chunks: the same for W (N, K), else chunk c = tid + i
  // kThreads of the stage's kStep x BN block of W (K, N), at row wk(c) and
  // columns wn4(c) .. + 3, n fastest across a warp
  constexpr int kRowStep = kThreads / kCPR;
  const int ck = tid % kCPR, ar0 = tid / kCPR;
  auto wk = [](int c) { return c / (BN / 4); };
  auto wn4 = [](int c) { return c % (BN / 4) * 4; };
  // the residual tile into L2 now, one row segment per row (the threads
  // of chunk column 0 cover every row), so the epilogue reads it from L2
  if (VEC_X && p.res && p.vec_y && ck == 0) {
    const int bytes = 4 * (N - n0 < BN ? N - n0 : BN);
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i)
      if (ar0 + i * kRowStep < rows)
        tc::prefetch_l2(p.res + (m0 + ar0 + i * kRowStep) * N + n0, bytes);
  }
  auto issue = [&](int st) {
    float* Xh = ring + (st % kStages) * C::kStageFloats;
    float* Xl = Xh + kBM * kLd;
    float* Wh = Xl + kBM * kLd;
    float* Wl = Wh + C::kWTile;
    const int kc = st * kStep + ck * 4;
    if (VEC_X) {
#pragma unroll
      for (int i = 0; i < C::kAPer; ++i) {
        const int r = ar0 + i * kRowStep;
        const bool ok = r < rows && kc < K;
        tc::cp_async16(Xh + r * kLd + ck * 4, ok ? p.x + rowoff[r] + kc : p.x, ok);
      }
    } else {
      // element by element, transformed and split on the way in; made
      // visible by the barrier that starts the stage
      float s[4], h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = kc + j < K ? p.scale[kc + j] : 0.0f;
        h[j] = kc + j < K ? p.shift[kc + j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < C::kAPer; ++i) {
        const int r = ar0 + i * kRowStep;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = r < rows && kc + j < K;
          split_f(ok ? affine_relu(p.x[rowoff[r] + (int64_t)(kc + j) * p.sk], s[j], h[j]) : 0.0f,
                  Xh[r * kLd + ck * 4 + j], Xl[r * kLd + ck * 4 + j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::kBPer; ++i) {
      if constexpr (!W_KN) {
        const int r = ar0 + i * kRowStep, n = n0 + r;
        float* dst = Wh + r * kLd + ck * 4;
        const float* src = p.w + (int64_t)n * K + kc;
        if (p.vec_w) {
          const bool ok = n < N && kc < K;
          tc::cp_async16(dst, ok ? src : p.w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_f(n < N && kc + j < K ? src[j] : 0.0f, dst[j], Wl[r * kLd + ck * 4 + j]);
        }
      } else {
        const int c = tid + i * kThreads, kr = wk(c), nc = wn4(c);
        const int k = st * kStep + kr, n = n0 + nc;
        const float* src = p.w + (int64_t)k * N + n;
        if (p.vec_w) {
          const bool ok = k < K && n < N;
          tc::cp_async16(Wh + kr * C::kLdw + nc, ok ? src : p.w, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_f(k < K && n + j < N ? src[j] : 0.0f, Wh[kr * C::kLdw + nc + j],
                    Wl[kr * C::kLdw + nc + j]);
        }
      }
    }
  };

  // scale and shift of this thread's chunk column in stage st (loaded
  // before the wait for its copies, so the two latencies overlap)
  auto affine = [&](int st, float4 (&sv)[2]) {
    const int kc = st * kStep + ck * 4;
    sv[0] = sv[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (VEC_X && kc < K) {
      sv[0] = __ldg(reinterpret_cast<const float4*>(p.scale + kc));
      sv[1] = __ldg(reinterpret_cast<const float4*>(p.shift + kc));
    }
  };
  // the prologue and split of stage st in place, on the chunks this
  // thread copied (the element-by-element ones were done at the copy)
  auto transform = [&](int st, const float4 (&sv)[2]) {
    float* Xh = ring + (st % kStages) * C::kStageFloats;
    float* Xl = Xh + kBM * kLd;
    float* Wh = Xl + kBM * kLd;
    float* Wl = Wh + C::kWTile;
    const bool k_ok = st * kStep + ck * 4 < K;
    if (VEC_X) {
#pragma unroll
      for (int i = 0; i < C::kAPer; ++i) {
        const int o = (ar0 + i * kRowStep) * kLd + ck * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f), lo = v;
        if (ar0 + i * kRowStep < rows && k_ok) {
          v = *reinterpret_cast<const float4*>(Xh + o);
          prologue4(v, lo, sv[0], sv[1]);
        }
        *reinterpret_cast<float4*>(Xh + o) = v;
        *reinterpret_cast<float4*>(Xl + o) = lo;
      }
    }
    if (p.vec_w) {
#pragma unroll
      for (int i = 0; i < C::kBPer; ++i) {
        const int c = tid + i * kThreads;
        const int o = W_KN ? wk(c) * C::kLdw + wn4(c) : (ar0 + i * kRowStep) * kLd + ck * 4;
        float4 v = *reinterpret_cast<const float4*>(Wh + o), lo;
        split4(v, lo);
        *reinterpret_cast<float4*>(Wh + o) = v;
        *reinterpret_cast<float4*>(Wl + o) = lo;
      }
    }
  };

  float acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nst = (K + kStep - 1) / kStep;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }
  {
    float4 sv[2];
    affine(0, sv);
    tc::cp_async_wait<kStages - 2>();               // my copies of stage 0 landed
    if (nst > 0) transform(0, sv);
  }
  // ldmatrix rows and columns of this lane (tc_mma.cuh): A from X's (m, k)
  // rows, B from W's (n, k) rows, two n8 tiles a load; or, for W (K, N),
  // the scalar B loads' (k, n) element of this lane
  const int a_off = (wm * C::kWM + (lane & 15)) * kLd + (lane >> 4) * 4;
  const int b_off = W_KN
      ? (lane & 3) * C::kLdw + wn * C::kWN + (lane >> 2)
      : (wn * C::kWN + (lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 4;

  // Stage st: the barrier makes its tiles (transformed and split in
  // iteration st - 1) visible and frees stage st - 1's buffer for the
  // copy of stage st + kStages - 1; after the products, this thread's
  // copies of stage st + 1 have landed and it transforms them (that
  // buffer is neither read nor written by another thread in this
  // iteration).
  for (int st = 0; st < nst; ++st) {
    const float* Xh = ring + (st % kStages) * C::kStageFloats;
    const float* Xl = Xh + kBM * kLd;
    const float* Wh = Xl + kBM * kLd;
    const float* Wl = Wh + C::kWTile;
    __syncthreads();
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    tc::cp_async_commit();
#pragma unroll
    for (int k0 = 0; k0 < kStep / 8; k0 += kGroup) {
      // W's fragments of the group: n8 tile nt, k step kk, hi and lo
      uint32_t bh[C::kNT][kGroup][2], bl[C::kNT][kGroup][2];
      if constexpr (!W_KN) {
#pragma unroll
        for (int np = 0; np < C::kNT / 2; ++np)
#pragma unroll
          for (int kk = 0; kk < kGroup; ++kk) {
            uint32_t f[4];
            const int o = b_off + np * 16 * kLd + (k0 + kk) * 8;
            tc::ldsm_x4(f, Wh + o);
            bh[2 * np][kk][0] = f[0], bh[2 * np][kk][1] = f[1];
            bh[2 * np + 1][kk][0] = f[2], bh[2 * np + 1][kk][1] = f[3];
            tc::ldsm_x4(f, Wl + o);
            bl[2 * np][kk][0] = f[0], bl[2 * np][kk][1] = f[1];
            bl[2 * np + 1][kk][0] = f[2], bl[2 * np + 1][kk][1] = f[3];
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
          for (int kk = 0; kk < kGroup; ++kk) {
            const int o = b_off + (k0 + kk) * 8 * C::kLdw + nt * 8;
            bh[nt][kk][0] = __float_as_uint(Wh[o]);
            bh[nt][kk][1] = __float_as_uint(Wh[o + 4 * C::kLdw]);
            bl[nt][kk][0] = __float_as_uint(Wl[o]);
            bl[nt][kk][1] = __float_as_uint(Wl[o + 4 * C::kLdw]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        // each n8 tile's chain in a fresh fragment of its own; the A
        // fragments of the group loaded at once, or (the element-by-element
        // instances) one k step at a time: the same sums in the same
        // order.  The split is ptxas's register allocation at the
        // 128-register cap, and chip_smoke.py's no-spill check guards
        // it: with the group at once everywhere, row 10's 128 x 128
        // element-by-element instance (<128, true, false>) spilled 4-8
        // bytes; with a k step at a time everywhere, its 128 x 128
        // cp.async instance (<128, true, true>) spilled 4 (H100 runs of
        // tools/torch_fused_tune.py --dtype float32; row 7's instances
        // spilled with neither form)
        float c[C::kNT][4] = {};
        if constexpr (VEC_X) {
          uint32_t ah[kGroup][4], al[kGroup][4];
#pragma unroll
          for (int kk = 0; kk < kGroup; ++kk) {
            const int o = a_off + mt * 16 * kLd + (k0 + kk) * 8;
            tc::ldsm_x4(ah[kk], Xh + o);
            tc::ldsm_x4(al[kk], Xl + o);
          }
#pragma unroll
          for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
            for (int kk = 0; kk < kGroup; ++kk)
              tc::mma3(c[nt], ah[kk], al[kk], bh[nt][kk][0], bh[nt][kk][1], bl[nt][kk][0],
                       bl[nt][kk][1]);
        } else {
#pragma unroll
          for (int kk = 0; kk < kGroup; ++kk) {
            uint32_t ah[4], al[4];
            const int o = a_off + mt * 16 * kLd + (k0 + kk) * 8;
            tc::ldsm_x4(ah, Xh + o);
            tc::ldsm_x4(al, Xl + o);
#pragma unroll
            for (int nt = 0; nt < C::kNT; ++nt)
              tc::mma3(c[nt], ah, al, bh[nt][kk][0], bh[nt][kk][1], bl[nt][kk][0],
                       bl[nt][kk][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[nt][e];
      }
    }
    float4 sv[2];
    affine(st + 1, sv);
    tc::cp_async_wait<kStages - 2>();               // my copies of stage st + 1 landed
    if (st + 1 < nst) transform(st + 1, sv);
  }

  // epilogue: the f32 tile through shared memory, then 16-byte vectors
  tc::cp_async_wait<0>();
  __syncthreads();                                  // every warp is done with the ring
  float* Cs = ring;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
      float* c = Cs + (wm * C::kWM + mt * 16 + g) * C::kLdc + wn * C::kWN + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(c) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(c + 8 * C::kLdc) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  if (p.vec_y) {
    constexpr int kC4 = BN / 4;
    for (int c = tid; c < kBM * kC4; c += kThreads) {
      const int r = c / kC4, c4 = (c % kC4) * 4;
      const int64_t m = m0 + r;
      const int n = n0 + c4;
      if (m >= p.M || n >= N) continue;
      float4 v = *reinterpret_cast<const float4*>(Cs + r * C::kLdc + c4);
      if (p.res) {
        const float4 rr = __ldg(reinterpret_cast<const float4*>(p.res + m * N + n));
        v.x = __fadd_rn(v.x, rr.x);
        v.y = __fadd_rn(v.y, rr.y);
        v.z = __fadd_rn(v.z, rr.z);
        v.w = __fadd_rn(v.w, rr.w);
      }
      *reinterpret_cast<float4*>(p.y + m * N + n) = v;
    }
  } else {
    for (int c = tid; c < kBM * BN; c += kThreads) {
      const int r = c / BN, cc = c % BN;
      const int64_t m = m0 + r;
      const int n = n0 + cc;
      if (m >= p.M || n >= N) continue;
      float v = Cs[r * C::kLdc + cc];
      if (p.res) v = __fadd_rn(v, p.res[m * N + n]);
      p.y[m * N + n] = v;
    }
  }
}

template <int BN, bool W_KN, bool VEC_X>
cudaError_t launch_tile(Args a, cudaStream_t stream) {
  using C = Cfg<BN, W_KN>;
  const auto kernel = fused_gemm_f32_kernel<BN, W_KN, VEC_X>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  a.tiles_n = (a.N + BN - 1) / BN;
  const int64_t blocks = (a.M + kBM - 1) / kBM * a.tiles_n;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// One launch: 128 x 128 tiles, or 128 x 64 when N <= 64 or when 128 x
// 128 tiles would not make two waves over an H100's 132 SMs (the same
// tile for rows 7 and 10 at one M, K and N).  vec_x: X's channel stride
// is 1, K % 4 == 0, and every row, scale and shift are 16-byte aligned.
template <bool W_KN>
int run(const Args& a, bool vec_x, cudaStream_t s) {
  if (a.N <= 64 || (a.M + kBM - 1) / kBM * ((a.N + 127) / 128) < 2 * kSMs)
    return (int)(vec_x ? launch_tile<64, W_KN, true>(a, s) : launch_tile<64, W_KN, false>(a, s));
  return (int)(vec_x ? launch_tile<128, W_KN, true>(a, s) : launch_tile<128, W_KN, false>(a, s));
}

// dynamic shared memory of the tile with bn columns, bytes
template <bool W_KN>
int smem_bytes(int bn) {
  return (int)(bn == 64 ? Cfg<64, W_KN>::kSmem : Cfg<128, W_KN>::kSmem);
}

}  // namespace f32
}  // namespace fused_gemm
