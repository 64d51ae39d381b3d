// The 16-bit fused BatchNorm-apply, ReLU and 1x1 convolution on Hopper's
// tensor cores (sm_90a): one GEMM main loop, a template over the element
// type T (bf16 or f16, through tc::T16<T>: the m16n8k16 product, pack,
// unpack and rounding of that type), shared by the bf16 and f16 launches
// of fused_matmul.cu (TPU kernel row 7, mxnet_tpu/ops/fused.py
// _pallas_fwd) and fused_band4d.cu (row 10, tools/fused_sandwich_bench.py
// pal4d_band):
//
//   Y[M, N] = T( f32( T(relu(f32(X) * scale + shift)) @ W ) (+ f32(R)) )
//
// X's rows are read through four strides (b, h, w, k): row 7 passes a
// contiguous (M, K) matrix as one image row of M pixels, row 10 its 4-D
// channel-last tensor as it is.  W is (N, K) row-major for row 7 (the
// OHWI weight as stored) and (K, N) for row 10 (W_KN).  scale and shift
// are f32 (K,); the residual R (row 7 only) and Y are contiguous (M, N).
// The TPU kernel's rounding points: the affine in f32 with the multiply
// and the add rounded separately (__fmul_rn, __fadd_rn, as the plain
// versions compute them), the ReLU (NaN passes, as torch.relu passes
// it), the activation rounded to T (to nearest even) before the product,
// the product summed in f32 (.f32.bf16.bf16.f32 or .f32.f16.f16.f32),
// the residual added in f32, the output rounded once.  In f16 an
// activation or a sum past 65504 rounds to inf, as the plain version's
// .to(float16) rounds it.  Both instances run the same instructions but
// the mma opcode and the conversions, so they take the same registers.
//
// What bounds it on the H100: 2*M*N*K operations against 2*(M*K + K*N +
// M*N (+ M*N)) bytes.  At the tensor cores' dense 989 TFLOP/s and 3.35
// TB/s every ResNet-50 site at batch 256 but one (12544 x 2048 -> 512,
// bound by operations) and both bands of the fused sandwich are bound by
// bytes: the sandwich's bands need 0.077 ms, which takes about 340
// TFLOP/s of products, and torch.matmul's 0.102 ms about 260.  That is
// within mma.sync's reach (the bf16 flash kernels of flash_attention.cu
// reach 148-177 TFLOP/s with a softmax between their products; a GEMM's
// main loop has none), so this is mma.sync m16n8k16 with the building
// blocks of tc_mma.cuh, not wgmma.
//
// Design.  A block of kWarps = 8 warps computes one 128 x 128 tile of Y
// (128 x 64 when N <= 64), each warp a 64 x 32 (32 x 32) sub-tile of
// m16n8 f32 accumulators in registers: 64 a thread, which with the
// fragments fills the 128 registers that let two blocks share an SM.  K
// is walked in stages of kStep = 64 columns through a cp.async ring of
// kStages = 3 stages in shared memory: 16-bit tiles with rows padded by 8
// elements, so the 8 row addresses of every ldmatrix (and ldmatrix.trans
// for row 10's (K, N) W) fall on distinct 16-byte bank groups.  Blocks
// walk N fastest, so the blocks that share a tile of X rows run together
// and read it from L2.  A block with a residual first asks L2 for its
// residual tile (cp.async.bulk.prefetch.L2, one row segment a thread),
// so the epilogue's reads find it there.
//
// What holds it back (tools/torch_fused_tune.py, its --diagnose
// variants, on an H100 at ResNet-50's 28 sites at batch 256): the
// tensor cores are not the limit.  Leaving out the mma instructions
// saved 5.5% of the step, leaving out the prologue 18%, W's copies 8%
// (every 128-row tile reads W again from L2: 205 MB at each of the 8
// sites), Y's stores 6%.  Tiles of 128 x 128 are the largest whose
// accumulators two blocks an SM can hold, and the 128 x 128 instances
// sit at that 128-register cap: the X row offsets live in a shared-memory
// table, one A fragment is loaded at a time, and row 10's instances
// walk a thread's chunks one by one (kChunkUnroll), each of which a spill
// once forced.  Tried and slower: one 16-warp block an SM (32 x 32
// sub-tiles, every warp in lock-step at each barrier), a persistent grid
// whose ring ran across tiles (its state spilled the accumulators),
// 32-column K steps; no faster: 64-row tiles for small M, L2 prefetch of
// X ahead of the ring.
//
// The prologue runs once per element per block.  A thread copies the
// same 8-column chunk of K in every X row it stages.  After the products
// of stage st, once cp.async.wait_group says its copies of stage st + 1
// have landed, it rewrites those chunks in place (widen, affine, ReLU,
// round to T) with the chunk's scale and shift, loaded just before
// that wait; the barrier that starts stage st + 1, which the ring needs
// anyway, publishes them.  No warp repeats another's prologue, and the
// prologue is independent of the fragment layout.  Padding is zero
// AFTER the prologue: a zero-filled X element would become relu(shift),
// so rows past M and columns past K are written as zeros by the prologue
// itself.  Zero-filled copies take the tensor's base as their source
// pointer, never an address past its end.
//
// Ragged edges: any M, K and N.  Every stage runs kStep / 16 product
// steps, a compile-time count with no branch inside; the last stage of
// a K that is not a multiple of kStep multiplies zeros (W's columns
// past K are zero-filled too).  X stages by 16-byte cp.async when its
// channel stride is 1 and every row is 16-byte aligned (VEC_X: a
// contiguous tensor, a channels_last view, an aligned channel slice);
// otherwise (an NHWC view of an NCHW tensor, K % 8 != 0, an unaligned
// pointer) each thread loads, transforms and stores its elements one by
// one into the same stage, still on the tensor cores.  W and Y take the
// same choice at run time (vec_w, vec_y).  The epilogue stages the f32
// accumulators through shared memory (rows padded by 8 floats, so the
// fragments' 8-byte stores are free of bank conflicts), then each thread
// reads the residual and writes Y in 16-byte vectors: the m16n8
// accumulator layout alone would give 4-byte stores.
//
// Determinism: no split over K and no atomics, so two runs give the same
// bits.  Each output is the f32 sum of its k16 slices in order, whatever
// the tile shape, so rows 7 and 10 give the same bits on the same
// operands (the sandwich's pal2d and pal4d arms are held bit-equal).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace fused_gemm {

using tc::bf16;
using tc::f16;
using tc::T16;

// K columns per stage, stages of the ring, warps a block and blocks an
// SM (a register budget for ptxas; tools/torch_fused_tune.py times
// variants of these), and the rows of a tile
constexpr int kStep = 64, kStages = 3, kWarps = 8, kMinBlocks = 2;
constexpr int kBM = 128;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;           // 16-bit elements of padding per shared-memory row
constexpr int kCPad = 8;          // f32 of padding per row of the epilogue tile
constexpr int kCPR = kStep / 8;   // 16-byte chunks per X row of a stage

// A launch's operands, in element type T (bf16 and f16 for this GEMM,
// float for the one of fused_gemm_f32.cuh): X's row m = (b, h, w) at
// element offset b sb + h sh + w sw, its channels sk apart
template <typename T>
struct GemmArgs {
  const T* x;
  const float* scale;
  const float* shift;
  const T* w;
  const T* res;         // (M, N) or null
  T* y;
  int64_t M, HW, Wd;    // rows; pixels per image and per image row
  int64_t sb, sh, sw, sk;
  int K, N;
  int vec_w, vec_y;
  int tiles_n;          // set by launch_tile
};

// each of a tile's BM rows' element offset in X from its (b, h, w), in a
// table in shared memory (rows past M: 0), published by a barrier
template <int BM, int NT, typename T>
__device__ __forceinline__ void row_offsets(int64_t* rowoff, const GemmArgs<T>& p, int64_t m0,
                                            int rows) {
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int64_t m = m0 + r;
    int64_t off = 0;
    if (r < rows) {
      const int64_t b = m / p.HW, q = m - b * p.HW;
      const int64_t h = q / p.Wd, ww = q - h * p.Wd;
      off = b * p.sb + h * p.sh + ww * p.sw;
    }
    rowoff[r] = off;
  }
  __syncthreads();
}

template <int BN, bool W_KN>
struct Cfg {
  static constexpr int BM = kBM;
  static constexpr int kWarpsM = BM > BN ? kWarps / 2 : 2;
  static constexpr int kWarpsN = kWarps / kWarpsM;
  static constexpr int kWM = BM / kWarpsM, kWN = BN / kWarpsN;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;    // m16 and n8 tiles a warp
  static constexpr int kLda = kStep + kPad;
  static constexpr int kLdb = W_KN ? BN + kPad : kStep + kPad;
  static constexpr int kStageElems = BM * kLda + (W_KN ? kStep : BN) * kLdb;
  static constexpr int kAPer = BM * kCPR / kThreads;      // X chunks a thread
  static constexpr int kBPer = BN * kCPR / kThreads;      // W chunks a thread
  static constexpr int kLdc = BN + kCPad;                 // the epilogue's f32 tile
  // chunk loops (issue, prologue) unrolled for row 7; row 10's (K, N) W
  // path takes a few more registers, and handling a thread's chunks
  // together there spills the accumulators, so it walks them one by one
  static constexpr int kChunkUnroll = W_KN ? 1 : kAPer > kBPer ? kAPer : kBPer;
  static constexpr size_t kRing = 2 * kStages * kStageElems;   // 16-bit elements
  // the row-offset table sits past both the ring and the epilogue's tile
  static constexpr size_t kRowOff =
      kRing > sizeof(float) * BM * kLdc ? kRing : sizeof(float) * BM * kLdc;
  static constexpr size_t kSmem = kRowOff + sizeof(int64_t) * BM;
  static_assert(kMT >= 1 && kNT >= 2 && kNT % 2 == 0, "warp tile");
  static_assert(kAPer >= 1 && BM * kCPR % kThreads == 0, "X chunks");
  static_assert(kBPer >= 1 && BN * kCPR % kThreads == 0, "W chunks");
  static_assert(kThreads % kCPR == 0, "a thread keeps one chunk column");
  static_assert(kStages >= 3, "stage st + 1 is transformed while st is read");
};

__device__ __forceinline__ float affine_relu(float x, float s, float h) {
  const float z = __fadd_rn(__fmul_rn(x, s), h);
  return z < 0.0f ? 0.0f : z;
}

template <typename T, int BN, bool W_KN, bool VEC_X>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_gemm16_kernel(const GemmArgs<T> p) {
  using C = Cfg<BN, W_KN>;
  using E = T16<T>;
  constexpr int BM = kBM;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int64_t m0 = (int64_t)(blockIdx.x / p.tiles_n) * BM;
  const int n0 = (int)(blockIdx.x % p.tiles_n) * BN;
  const int K = p.K, N = p.N;

  // the tile's valid rows, and each row's element offset in X from its
  // (b, h, w) in a table in shared memory (not registers: the 128 x 128
  // tile's accumulators leave none to spare)
  const int rows = (int)(p.M - m0 < BM ? p.M - m0 : BM);
  int64_t* rowoff = reinterpret_cast<int64_t*>(smem + C::kRowOff);
  row_offsets<BM, kThreads>(rowoff, p, m0, rows);
  // this thread's X chunks: column ck (8 elements of K) of rows ar0 + i *
  // kRowStep
  constexpr int kRowStep = kThreads / kCPR;
  const int ck = tid % kCPR, ar0 = tid / kCPR;
  // the residual tile into L2 now, one row segment per row (the threads
  // of chunk column 0 cover every row), so the epilogue reads it from L2
  // (the element-by-element instances skip it: their odd shapes are not
  // worth the registers)
  if (VEC_X && p.res && p.vec_y && ck == 0) {
    const int bytes = 2 * (N - n0 < BN ? N - n0 : BN);
#pragma unroll
    for (int i = 0; i < C::kAPer; ++i)
      if (ar0 + i * kRowStep < rows)
        tc::prefetch_l2(p.res + (m0 + ar0 + i * kRowStep) * N + n0, bytes);
  }
  auto issue = [&](int st) {
    T* As = ring + (st % kStages) * C::kStageElems;
    T* Bs = As + BM * C::kLda;
    const int k0 = st * kStep, kc = k0 + ck * 8;
    if (VEC_X) {
#pragma unroll (C::kChunkUnroll)
      for (int i = 0; i < C::kAPer; ++i) {
        const int r = ar0 + i * kRowStep;
        const bool ok = r < rows && kc < K;
        tc::cp_async16(As + r * C::kLda + ck * 8, ok ? p.x + rowoff[r] + kc : p.x, ok);
      }
    } else {
      // element by element, transformed on the way in; made visible by
      // the barrier that starts the stage
      float s[8], h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = kc + j < K ? p.scale[kc + j] : 0.0f;
        h[j] = kc + j < K ? p.shift[kc + j] : 0.0f;
      }
#pragma unroll (C::kChunkUnroll)
      for (int i = 0; i < C::kAPer; ++i) {
        const int r = ar0 + i * kRowStep;
        T* dst = As + r * C::kLda + ck * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool ok = r < rows && kc + j < K;
          dst[j] = E::round(
              ok ? affine_relu(E::widen(p.x[rowoff[r] + (int64_t)(kc + j) * p.sk]), s[j], h[j])
                 : 0.0f);
        }
      }
    }
#pragma unroll (C::kChunkUnroll)
    for (int i = 0; i < C::kBPer; ++i) {
      const int c = tid + i * kThreads;
      // W_KN: row k0 + r of (K, N), columns n0 + c8 ..; else row n0 + r
      // of (N, K), columns k0 + c8 ..
      const int r = W_KN ? c / (BN / 8) : c / kCPR;
      const int c8 = (W_KN ? c % (BN / 8) : c % kCPR) * 8;
      const int k = W_KN ? k0 + r : k0 + c8, n = W_KN ? n0 + c8 : n0 + r;
      T* dst = Bs + r * C::kLdb + c8;
      const int64_t at = W_KN ? (int64_t)k * N + n : (int64_t)n * K + k;
      if (p.vec_w) {
        const bool ok = k < K && n < N;
        tc::cp_async16(dst, ok ? p.w + at : p.w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool ok = W_KN ? (k < K && n + j < N) : (n < N && k + j < K);
          dst[j] = ok ? p.w[at + j] : E::round(0.0f);
        }
      }
    }
  };

  // scale and shift of this thread's chunk column in stage st (loaded
  // before the wait for its copies, so the two latencies overlap)
  auto affine = [&](int st, float4 (&sv)[4]) {
    const int kc = st * kStep + ck * 8;
    sv[0] = sv[1] = sv[2] = sv[3] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kc < K) {
      sv[0] = __ldg(reinterpret_cast<const float4*>(p.scale + kc));
      sv[1] = __ldg(reinterpret_cast<const float4*>(p.scale + kc + 4));
      sv[2] = __ldg(reinterpret_cast<const float4*>(p.shift + kc));
      sv[3] = __ldg(reinterpret_cast<const float4*>(p.shift + kc + 4));
    }
  };
  // the prologue of stage st in place, on the chunks this thread copied
  auto transform = [&](int st, const float4 (&sv)[4]) {
    T* As = ring + (st % kStages) * C::kStageElems;
    const bool k_ok = st * kStep + ck * 8 < K;
    const float s[8] = {sv[0].x, sv[0].y, sv[0].z, sv[0].w, sv[1].x, sv[1].y, sv[1].z, sv[1].w};
    const float h[8] = {sv[2].x, sv[2].y, sv[2].z, sv[2].w, sv[3].x, sv[3].y, sv[3].z, sv[3].w};
#pragma unroll (C::kChunkUnroll)
    for (int i = 0; i < C::kAPer; ++i) {
      uint4* q = reinterpret_cast<uint4*>(As + (ar0 + i * kRowStep) * C::kLda + ck * 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ar0 + i * kRowStep < rows && k_ok) {
        const uint4 raw = *q;
        const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 e = E::unpack(in[j]);
          out[j] = E::pack(affine_relu(e.x, s[2 * j], h[2 * j]),
                           affine_relu(e.y, s[2 * j + 1], h[2 * j + 1]));
        }
        v = make_uint4(out[0], out[1], out[2], out[3]);
      }
      *q = v;
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
  if (VEC_X && nst > 0) {
    float4 sv[4];
    affine(0, sv);
    tc::cp_async_wait<kStages - 2>();               // my copies of stage 0 landed
    transform(0, sv);
  } else {
    tc::cp_async_wait<kStages - 2>();
  }
  // ldmatrix row and column of this lane: A (m, k); B (n, k) or, .trans,
  // (k, n)
  const int a_row = wm * C::kWM + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = W_KN ? (lane & 7) + (((lane >> 3) & 1) << 3)
                         : wn * C::kWN + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = W_KN ? wn * C::kWN + ((lane >> 4) << 3) : ((lane >> 3) & 1) * 8;

  // Stage st: the barrier makes its tiles (X transformed in iteration
  // st - 1) visible and frees stage st - 1's buffer for the copy of
  // stage st + kStages - 1; after the products, this thread's copies of
  // stage st + 1 have landed and it transforms them (kStages >= 3, so
  // that buffer is neither read nor written in this iteration).
  for (int st = 0; st < nst; ++st) {
    const T* As = ring + (st % kStages) * C::kStageElems;
    const T* Bs = As + BM * C::kLda;
    __syncthreads();
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    tc::cp_async_commit();
    // one A fragment at a time against all of B's: 12 fragment registers
    // instead of 24, which keeps the 128 x 128 tile under 128 registers
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      uint32_t b[C::kNT][2];
#pragma unroll
      for (int np = 0; np < C::kNT / 2; ++np) {
        uint32_t f[4];
        if (W_KN)
          tc::ldsm_x4_trans(f, Bs + (kk * 16 + b_row) * C::kLdb + b_col + np * 16);
        else
          tc::ldsm_x4(f, Bs + (b_row + np * 16) * C::kLdb + kk * 16 + b_col);
        b[2 * np][0] = f[0];
        b[2 * np][1] = f[1];
        b[2 * np + 1][0] = f[2];
        b[2 * np + 1][1] = f[3];
      }
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) {
        uint32_t a[4];
        tc::ldsm_x4(a, As + (a_row + mt * 16) * C::kLda + kk * 16 + a_col);
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) E::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    if (VEC_X && st + 1 < nst) {
      float4 sv[4];
      affine(st + 1, sv);
      tc::cp_async_wait<kStages - 2>();             // my copies of stage st + 1 landed
      transform(st + 1, sv);
    } else {
      tc::cp_async_wait<kStages - 2>();
    }
  }

  // epilogue: the f32 tile through shared memory, then 16-byte vectors
  tc::cp_async_wait<0>();
  __syncthreads();                                  // every warp is done with the ring
  float* Cs = reinterpret_cast<float*>(smem);
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
    constexpr int kC8 = BN / 8;
    for (int c = tid; c < BM * kC8; c += kThreads) {
      const int r = c / kC8, c8 = (c % kC8) * 8;
      const int64_t m = m0 + r;
      const int n = n0 + c8;
      if (m >= p.M || n >= N) continue;
      const float4 lo = *reinterpret_cast<const float4*>(Cs + r * C::kLdc + c8);
      const float4 hi = *reinterpret_cast<const float4*>(Cs + r * C::kLdc + c8 + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (p.res) {
        const uint4 rr = __ldg(reinterpret_cast<const uint4*>(p.res + m * N + n));
        const uint32_t rv[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 e = E::unpack(rv[j]);
          v[2 * j] = __fadd_rn(v[2 * j], e.x);
          v[2 * j + 1] = __fadd_rn(v[2 * j + 1], e.y);
        }
      }
      *reinterpret_cast<uint4*>(p.y + m * N + n) =
          make_uint4(E::pack(v[0], v[1]), E::pack(v[2], v[3]), E::pack(v[4], v[5]),
                     E::pack(v[6], v[7]));
    }
  } else {
    for (int c = tid; c < BM * BN; c += kThreads) {
      const int r = c / BN, cc = c % BN;
      const int64_t m = m0 + r;
      const int n = n0 + cc;
      if (m >= p.M || n >= N) continue;
      float v = Cs[r * C::kLdc + cc];
      if (p.res) v = __fadd_rn(v, E::widen(p.res[m * N + n]));
      p.y[m * N + n] = E::round(v);
    }
  }
}

template <typename T, int BN, bool W_KN, bool VEC_X>
cudaError_t launch_tile(GemmArgs<T> a, cudaStream_t stream) {
  using C = Cfg<BN, W_KN>;
  const auto kernel = fused_gemm16_kernel<T, BN, W_KN, VEC_X>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  a.tiles_n = (a.N + BN - 1) / BN;
  const int64_t blocks = (a.M + kBM - 1) / kBM * a.tiles_n;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// One launch: 128 x 128 tiles, or 128 x 64 when N <= 64.  vec_x: X's
// channel stride is 1, K % 8 == 0, and every row, scale and shift are
// 16-byte aligned.  T is bf16 or f16.
template <typename T, bool W_KN>
int run(const GemmArgs<T>& a, bool vec_x, cudaStream_t s) {
  if (a.N <= 64)
    return (int)(vec_x ? launch_tile<T, 64, W_KN, true>(a, s)
                       : launch_tile<T, 64, W_KN, false>(a, s));
  return (int)(vec_x ? launch_tile<T, 128, W_KN, true>(a, s)
                     : launch_tile<T, 128, W_KN, false>(a, s));
}

// dynamic shared memory of the tile with bn columns, bytes (the same for
// both 16-bit types)
template <bool W_KN>
int smem_bytes(int bn) {
  return (int)(bn == 64 ? Cfg<64, W_KN>::kSmem : Cfg<128, W_KN>::kSmem);
}

}  // namespace fused_gemm
