// f32 causal attention on Hopper's tensor cores (sm_90a), the pieces
// shared by the f32 attention kernels: the flash forward, dK/dV and dQ of
// flash_attention.cu (TPU kernel row 8, mxnet_tpu/ops/nn.py:744
// _flash_attention), and the one-shot and chunked prefills of
// paged_attention.cu (rows 5 and 2, mxnet_tpu/pallas/attention.py:209
// paged_prefill_attend and :360 paged_chunk_prefill_attend), whose
// forwards are the flash forward over seq-major (B, S, H, D) rows, the
// chunked prefill's keys gathered through the block table.
//
// Split TF32 ("3xTF32", tc_mma.cuh: split, mma3).  One TF32 product
// would leave the f32 forms' tolerance (rtol 1e-4 / atol 1e-5 against the
// plain f32 version; a 128-term score sum is off by ~5e-4), so every
// product step issues three mma.sync m16n8k8 on the hi and lo halves of
// its operands; this is the arithmetic of PyTorch's memory-efficient SDPA
// in f32 (CUTLASS's OpMultiplyAddFastF32 on sm80 and later), the kernels'
// yardstick.  The global TF32 flags are not involved: cuBLAS stays in
// full f32.  The tensor cores' own f32 accumulation does not round to
// nearest, so no mma chain runs long: products sum a few k steps into a
// fresh fragment, then add it to the accumulator in f32 (mma_nk, mma_kn).
//
// What bounds them on the H100.  One causal product over the lower
// triangle is B*H*S*(S+1)/2*D multiply-adds; the forward does two, dK/dV
// four and dQ three.  At the training shape (4, 16, 1024, 128) all are
// bound by operations: on the CUDA cores (67 TFLOP/s of f32 FMAs) 0.257
// / 0.513 / 0.385 ms; at three TF32 products per f32-accurate product on
// the dense 494.7 TFLOP/s tensor cores, ~165 TFLOP/s of f32 work, 0.104 /
// 0.209 / 0.156 ms, still above their bytes (0.020 / 0.030 / 0.025 ms).
//
// Design (FlashAttention-2's shape, as the bf16 kernels).  A warp owns
// 16 query rows (forward, dQ) or 16 keys (dK/dV) and walks the other
// axis up to or from the diagonal in steps of kStep rows; the online
// softmax (forward) and the accumulators stay in registers.  Operands
// are staged as f32 rows in a cp.async ring of kStages stages, with
// 16-byte copies when D % 4 == 0 and the bases are 16-byte aligned, and
// element by element otherwise (also every bf16 input, widened to f32
// on the way); rows past S are zero-filled, columns past a ragged chunk
// zero-padded to a multiple of 8.  The row stride is a parameter: D for
// flash's head-major (B, H, S, D), H * D for the prefill's seq-major
// input.  Shared rows are kLd = 132 floats (4 mod 32): the ldmatrix
// fragment loads (8 rows of 16 bytes each) and the scalar loads of the
// P V-type products (lane (g, t) reads rows 2t and 2t + 1 at column g:
// banks 8t + g and 8t + 4 + g) all hit 32 distinct banks.  The B
// operands, read by every warp, are split once as they land: each
// thread rewrites the elements it copied as hi and writes their lo to a
// second tile (split_tile), so a ring slot holds two tiles; the
// forward's V, whose stored split cost more than it saved, is split at
// each load.  The A operands (resident, or the accumulators P and dS)
// are split at each fragment load and reused across a row of n tiles.
//
// P and dS stay in registers.  The m16n8 accumulator of a score tile
// gives lane (g, t) keys 2t and 2t + 1; the m16n8k8 A fragment wants
// columns t and t + 4.  The P V product runs its k order permuted, A
// column t <-> key 2t and column t + 4 <-> key 2t + 1, and reads B's
// rows (k = t, t + 4) from keys 2t and 2t + 1 to match, so the
// accumulator IS the A fragment: no shuffle and no shared memory.  The
// same holds for dS in dQ = dS K and for P^T, dS^T in dK/dV.
//
// Head_dim goes in chunks of kDC = 128 columns: the score products sum
// over every chunk, each staged in turn, and the grid's third dimension
// walks the output chunks.  With D % 128 == 0 (kFull) the product loops
// have compile-time step counts and no branch (a branch per step cost
// the bf16 kernels 20-50%).  Exponentials are expf and logf (no fast
// math), so P is the plain version's to rounding.  Blocks run longest
// tiles first (the grid's y counts down).  No atomics: every result is
// deterministic, two runs bit-identical.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace attn32 {

using bf16 = __nv_bfloat16;

// Per kernel: warps a block (each owns 16 query rows, or 16 keys in
// dK/dV), blocks an SM should hold (a register budget for ptxas), rows a
// stage walks (keys, or query rows in dK/dV) and stages of the ring.
// dK/dV and dQ run kWarps warps at D <= 128 and kWideWarps above, where
// their A operands' rings take the shared memory.
constexpr int kFwdWarps = 4, kFwdMinBlocks = 2, kFwdStep = 32, kFwdStages = 2;
constexpr int kDkvWarps = 8, kDkvWideWarps = 4, kDkvStep = 16, kDkvStages = 2;
constexpr int kDqWarps = 8, kDqWideWarps = 4, kDqStep = 16, kDqStages = 2;
constexpr int kDC = 128;                     // head_dim columns per chunk
constexpr int kLd = kDC + 4;                 // smem row stride, floats (528 bytes)
constexpr int kGroup = 4;                    // k steps an mma chain sums (mma_nk)
static_assert(kFwdStep % 16 == 0 && kDkvStep % 16 == 0 && kDqStep % 16 == 0,
              "steps are whole pairs of n8 tiles");

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

using tc::mma3;
using tc::split;
using tc::split_f;
using tc::tf32_rna;

template <int N>
__device__ __forceinline__ void zero(float a[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 8-column steps over a chunk of width w: all 16 when every chunk is
// full (D % 128 == 0, a compile-time count), else w rounded up
template <bool kFull>
__device__ __forceinline__ int ksteps(int w) {
  return kFull ? kDC / 8 : (w + 7) >> 3;
}

// Stage rows [r0, r0 + R), columns [c0, c0 + w) of a matrix of S rows,
// rs elements apart, into an (R, kLd) f32 tile; zero rows past S and
// columns [w, w rounded up to 8).  vec: 16-byte cp.async (T = float, w
// and rs multiples of 4, the base 16-byte aligned; zero-filled copies
// read the base, never past the end); else element by element, widened
// to f32, made visible by the __syncthreads that starts the stage which
// reads the tile.
template <int R, int TH, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, int r0,
                                           int S, size_t rs, int c0, int w, bool vec) {
  const int wp = (w + 7) & ~7;
  const int l32 = threadIdx.x & 31;
  if (vec) {
    const int c = l32 * 4;
    if (c >= wp) return;
    for (int r = threadIdx.x >> 5; r < R; r += TH / 32) {
      const bool ok = r0 + r < S && c < w;
      tc::cp_async16(dst + r * kLd + c, ok ? src + (size_t)(r0 + r) * rs + c0 + c : src, ok);
    }
  } else {
    for (int r = threadIdx.x >> 5; r < R; r += TH / 32) {
      const bool row_ok = r0 + r < S;
      for (int c = l32; c < wp; c += 32)
        dst[r * kLd + c] =
            (row_ok && c < w) ? to_f32(src[(size_t)(r0 + r) * rs + c0 + c]) : 0.f;
    }
  }
}

// Rewrite as hi the elements of an (R, kLd) tile that this thread staged
// with stage_tile<R, TH> (the same w and vec, so the same elements), and
// write their lo halves to the tile lo.  Each thread runs it on its own
// elements once its copies of the stage have landed (cp.async.wait_group),
// before the __syncthreads that starts the stage: no extra barrier.
template <int R, int TH>
__device__ __forceinline__ void split_tile(float* t, float* lo, int w, bool vec) {
  const int wp = (w + 7) & ~7;
  const int l32 = threadIdx.x & 31;
  if (vec) {
    const int c = l32 * 4;
    if (c >= wp) return;
    for (int r = threadIdx.x >> 5; r < R; r += TH / 32) {
      float4* h = reinterpret_cast<float4*>(t + r * kLd + c);
      float4 x = *h, y;
      split_f(x.x, x.x, y.x);
      split_f(x.y, x.y, y.y);
      split_f(x.z, x.z, y.z);
      split_f(x.w, x.w, y.w);
      *h = x;
      *reinterpret_cast<float4*>(lo + r * kLd + c) = y;
    }
  } else {
    for (int r = threadIdx.x >> 5; r < R; r += TH / 32)
      for (int c = l32; c < wp; c += 32) split_f(t[r * kLd + c], t[r * kLd + c], lo[r * kLd + c]);
  }
}

// acc[NT] (16 x 8 NT) += A B^T: A the 16 rows [a_row0, +16) of a_tile
// (f32, split here), B the NT * 8 rows of the split tile b / b_lo (the n
// index), both over columns [0, 8 nk) (the k index).  Fragments by
// ldmatrix (see tc_mma.cuh).  Each kGroup k steps sum into a fresh
// fragment that an f32 add puts into acc (see mma_kn).
template <int NT>
__device__ __forceinline__ void mma_nk(float acc[][4], const float* a_tile, int a_row0,
                                       const float* b, const float* b_lo, int nk) {
  const int lane = threadIdx.x & 31;
  const float* ap = a_tile + (a_row0 + (lane & 15)) * kLd + (lane >> 4) * 4;
  const int bo = ((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int k0 = 0; k0 < kDC / 8; k0 += kGroup) {
    if (k0 < nk) {
      float c[NT][4];
      zero<NT>(c);
#pragma unroll
      for (int kk = k0; kk < k0 + kGroup; ++kk) {
        if (kk < nk) {
          uint32_t a[4], ah[4], al[4];
          tc::ldsm_x4(a, ap + kk * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t fh[4], fl[4];
            tc::ldsm_x4(fh, b + bo + np * 16 * kLd + kk * 8);
            tc::ldsm_x4(fl, b_lo + bo + np * 16 * kLd + kk * 8);
            mma3(c[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
            mma3(c[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += c[i][e];
    }
  }
}

// acc[16] (16 x 128) += P B: P the KT accumulator fragments p[KT] of an
// earlier 16 x 8 KT product taken as A fragments in permuted k order
// (A column t is key 2t, column t + 4 key 2t + 1), split here; B the
// split tile b / b_lo (8 KT rows, the k index) over columns [0, 8 ndp)
// (the n index), or with kSplitB the f32 tile b split here, lane (g, t)
// reading rows 2t and 2t + 1 of column g to match.  Each pair of k steps
// sums into a fresh fragment that an f32 add then puts into acc: the
// tensor cores' f32 accumulation does not round to nearest, and one
// fragment chained over a whole row of keys (384 mma at S = 1024)
// drifted past the f32 tolerance on an H100.
template <int KT, bool kSplitB = false>
__device__ __forceinline__ void mma_kn(float acc[kDC / 8][4], const float p[][4],
                                       const float* b, const float* b_lo, int ndp) {
  static_assert(KT % 2 == 0, "k steps go in pairs");
  const int lane = threadIdx.x & 31;
  const int bo = 2 * (lane & 3) * kLd + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < KT; kk += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split(p[kk + h][0], ah[h][0], al[h][0]);      // row g, key 2t
      split(p[kk + h][2], ah[h][1], al[h][1]);      // row g + 8, key 2t
      split(p[kk + h][1], ah[h][2], al[h][2]);      // row g, key 2t + 1
      split(p[kk + h][3], ah[h][3], al[h][3]);      // row g + 8, key 2t + 1
    }
#pragma unroll
    for (int dp = 0; dp < kDC / 8; ++dp) {
      if (dp < ndp) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = bo + (kk + h) * 8 * kLd + dp * 8;
          uint32_t bh0, bh1, bl0, bl1;
          if (kSplitB) {
            split(b[o], bh0, bl0);
            split(b[o + kLd], bh1, bl1);
          } else {
            bh0 = __float_as_uint(b[o]), bh1 = __float_as_uint(b[o + kLd]);
            bl0 = __float_as_uint(b_lo[o]), bl1 = __float_as_uint(b_lo[o + kLd]);
          }
          mma3(c, ah[h], al[h], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dp][e] += c[e];
      }
    }
  }
}

// rows g and g + 8 of a warp's 16 x 128 accumulator times mul[h]: rows
// [row0, row0 + 16) of the output (rows rs elements apart), columns
// [c0, c0 + w), rounded to T
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float acc[kDC / 8][4],
                                           int row0, int S, size_t rs, int c0, int w,
                                           const float mul[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= S) continue;
    T* orow = out + (size_t)r * rs + c0;
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        if (c < w) orow[c] = from_f32<T>(acc[nt][2 * h + e] * mul[h]);
      }
  }
}

// dynamic shared memory of the forward at head_dim D, bytes: a ring of
// split K/V tiles (hi, then lo), then Q (1 tile, or a ring when D > 128)
inline size_t fwd_smem(int D) {
  return sizeof(float) * kLd *
         (kFwdStages * 2 * kFwdStep + 16 * kFwdWarps * (D > kDC ? kFwdStages : 1));
}

// x: batch * head, y: tiles of 16 * warps rows (or keys), z: head_dim chunks
inline dim3 grid_of(int BH, int S, int D, int warps) {
  return dim3(BH, (S + 16 * warps - 1) / (16 * warps), (D + kDC - 1) / kDC);
}

// ------------------------------- forward -----------------------------
// One block: query rows [q0, q0 + R) of one head (R = 16 kFwdWarps, a
// warp's 16 rows each) against every key to the diagonal, output
// columns [oc0, oc0 + min(kDC, D - oc0)).  q, k, v and o point at the
// head's row 0, rows rs elements apart; lse (f32, the head's S rows) is
// written when not null.  Stages per key tile: one per head_dim chunk of
// Q K^T (K's chunk; Q's too when D > 128, else Q is resident), then one
// of P V (V's output chunk); K is split as it lands, Q (the A operand)
// and V at each fragment load (V split as it landed ran 6% slower on an
// H100: tools/torch_flash_tune.py fwd_raw_v).  Every row has a valid key
// (key 0) in the first tile, so the running max is finite from then on.
template <bool kFull, typename T>
__device__ __forceinline__ void forward(const T* __restrict__ qg, const T* __restrict__ kg,
                                        const T* __restrict__ vg, T* __restrict__ og,
                                        float* __restrict__ lse, int S, int D, size_t rs,
                                        int qt, int oc0, float scale, bool vec,
                                        float* smem) {
  constexpr int R = 16 * kFwdWarps, TH = 32 * kFwdWarps, KT = kFwdStep, NS = kFwdStages;
  constexpr int kQSlot = R * kLd, kKSlot = KT * kLd;    // a ring slot: 2 kKSlot
  const int nch = (D + kDC - 1) / kDC;
  const int ow = min(kDC, D - oc0);
  float* ring = smem;
  float* qs = ring + NS * 2 * kKSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * R;
  const int nkt = min((q0 + R + KT - 1) / KT, (S + KT - 1) / KT);  // to the diagonal
  const int per = nch + 1, nst = nkt * per;

  auto issue = [&](int st) {
    const int kt = st / per, j = st - kt * per, buf = st % NS;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) stage_tile<R, TH>(qs + buf * kQSlot, qg, q0, S, rs, c0, w, vec);
      stage_tile<KT, TH>(ring + buf * 2 * kKSlot, kg, kt * KT, S, rs, c0, w, vec);
    } else {
      stage_tile<KT, TH>(ring + buf * 2 * kKSlot, vg, kt * KT, S, rs, oc0, ow, vec);
    }
  };
  if (nch == 1) stage_tile<R, TH>(qs, qg, q0, S, rs, 0, D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }

  float s[KT / 8][4], acc[kDC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  zero<kDC / 8>(acc);
  for (int st = 0; st < nst; ++st) {
    const int kt = st / per, j = st - kt * per, buf = st % NS;
    float* tile = ring + buf * 2 * kKSlot;
    tc::cp_async_wait<NS - 2>();
    if (j < nch) split_tile<KT, TH>(tile, tile + kKSlot, min(kDC, D - j * kDC), vec);
    __syncthreads();                                // stage st landed, st - 1 done
    if (st + NS - 1 < nst) issue(st + NS - 1);
    tc::cp_async_commit();
    if (j < nch) {                                  // S += Q_j K_j^T
      if (j == 0) zero<KT / 8>(s);
      const int w = min(kDC, D - j * kDC);
      mma_nk<KT / 8>(s, qs + (nch > 1 ? buf : 0) * kQSlot, warp * 16, tile, tile + kKSlot,
                     ksteps<kFull>(w));
      continue;
    }
    // online softmax; on the tiles that cross the diagonal, keys past
    // the row (and past S) are -inf
    const int k0 = kt * KT;
    const bool diag = k0 + KT > q0 + 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (diag && (c > r || c >= S)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    mma_kn<KT / 8, true>(acc, s, tile, nullptr, ksteps<kFull>(ow));  // O += P V
  }
  tc::cp_async_wait<0>();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
  }
  const int row0 = q0 + warp * 16;
  store_rows(og, acc, row0, S, rs, oc0, ow, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r < S) lse[r] = m[h] + logf(l[h]);
    }
  }
}

}  // namespace attn32
