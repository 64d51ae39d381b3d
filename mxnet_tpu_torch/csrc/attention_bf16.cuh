// 16-bit causal attention on Hopper's tensor cores (sm_90a), the tile
// shared by the bf16/bf16 and f16/f16 instances (q/k/v and caches of one
// 16-bit type) of the one-shot and chunked prefills of paged_attention.cu:
// rows 5 and 2 of the kernel table, mxnet_tpu/pallas/attention.py:209
// paged_prefill_attend and :360 paged_chunk_prefill_attend.  The tile is
// a template over its element type T (tc::bf16 or tc::f16); tc::T16<T>
// gives the mma opcode, the packing, unpacking and rounding, and
// ldmatrix and cp.async move 16-bit values of either type alike.
//
// Numerics are the TPU kernels': they widen 16-bit q/k/v to f32 and sum
// both products in f32, P unrounded (attention.py:170-172, :328-330), and
// round the output to T once.  So:
// - Q K^T is one mma.sync.m16n8k16 a 16-column step, T operands and f32
//   sums: a bf16 times a bf16, and an f16 times an f16 (11-bit
//   significands, 22 bits a product), are exact in f32, so the products
//   are the plain version's and only the order of the sums differs.
// - P V takes P in two halves, hi = T(P) and lo = T(P - hi), two m16n8k16
//   products into one f32 accumulator: P is carried to about 16 bits in
//   bf16 (2^-17 relative) and 22 in f16, far under the output's 2^-9 or
//   2^-11, where the one-term P of row 8's flash forward (FlashAttention's
//   rounding, the TPU library kernel's p.astype(v.dtype)) carries 8 or 11.
//   The softmax sum l adds the unrounded P in f32.
// - f16 has 5 exponent bits: its normal range ends at 2^-14 and its
//   subnormals at 2^-24, where bf16 keeps f32's range.  A P of 2^-20 would
//   keep 5 of its bits as a subnormal hi and lose lo altogether.  So the
//   f16 tile carries P * 2^12 (at most 4096, exact: a power of two) into
//   the split and multiplies the accumulator by 2^-12 when it stores it,
//   which is exact too: hi stays normal down to P = 2^-26, lo keeps its
//   bits for P >= 2^-15, and what lo loses below that is under 2^-37 of
//   the largest P, far under the output's resolution.  bf16's scale is 1.
// Against the f32 instances the bf16 ones ran before (attention_f32.cuh on
// the bf16 values widened: three TF32 m16n8k8 a product step, of which
// the bf16 operand's lo half is 0), a product step takes one mma for
// Q K^T and two for P V in place of six TF32 ones, at twice the TF32 rate.
//
// The tile is PR 9's bf16 flash forward (flash_attention.cu, namespace
// tc): operands staged in shared memory in rows of kLds = 136 elements (a
// 272-byte stride puts the 8 rows an ldmatrix reads on 8 distinct groups
// of 4 banks), 16-byte cp.async copies into a ring of two stages (element
// by element when D % 8 != 0 or a base is not 16-byte aligned), ldmatrix
// for the Q and K fragments and ldmatrix.trans for V's; the score
// accumulator of two adjacent n8 tiles is, packed to T, the A fragment of
// the next m16k16 product, so P never leaves the registers
// (flash_attention.cu:39-55).  Exponentials are ex2.approx of scores
// pre-scaled by scale * log2(e) (relative error ~2^-22).  Head_dim goes
// in chunks of kDC = 128 columns: the score product sums over every chunk,
// each staged in turn, and the grid walks the output chunks, so there is
// no head_dim limit; with D % 128 == 0 (kFull) the product loops have
// compile-time step counts.  The row stride is a parameter (H * D for the
// prefills' seq-major rows).  No atomics: two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_mma.cuh"

namespace attn16 {

using bf16 = tc::bf16;
using f16 = tc::f16;

// The one-shot prefill's block: warps (each owns 16 query rows), blocks an
// SM ptxas budgets registers for, keys a stage walks, stages of the ring.
// Timed on an H100 (tools/torch_flash_tune.py --paged-bf16): 3 blocks an
// SM (168 registers, no spills) ran the served prefill 12% faster than 2
// (196-219 registers); 32-key steps and a ring of 3 were no faster.
constexpr int kFwdWarps = 4, kFwdMinBlocks = 3, kFwdStep = 64, kFwdStages = 2;
constexpr int kDC = 128;                     // head_dim columns per chunk
constexpr int kLds = kDC + 8;                // smem row stride, elements (272 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// P's scale in the P V product (2^12 for f16, 1 for bf16: the note above),
// and its inverse, applied to the accumulator as it is stored
template <typename T>
__host__ __device__ constexpr float p_scale() {
  return std::is_same<T, f16>::value ? 4096.f : 1.f;
}
template <typename T>
__host__ __device__ constexpr float p_unscale() {
  return 1.f / p_scale<T>();
}

// 2^x (ex2.approx.ftz: relative error ~2^-22; results below 2^-126 flush
// to 0, far under a bf16 output's resolution)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// 16-column steps over a chunk of width w: all 8 when every chunk is full
// (D % 128 == 0, a compile-time count), else w rounded up
template <bool kFull>
__device__ __forceinline__ int ksteps(int w) {
  return kFull ? kDC / 16 : (w + 15) >> 4;
}

// Stage rows [r0, r0 + R), columns [c0, c0 + w) of a matrix of S rows, rs
// elements apart, into an (R, kLds) tile of T; zero rows past S and
// columns [w, w rounded up to 16).  vec: 16-byte cp.async (D % 8 == 0 and
// the base 16-byte aligned, so rs, c0 and w are multiples of 8;
// zero-filled copies read the base, never past the end); else element by
// element, made visible by the __syncthreads that starts the stage which
// reads the tile.
template <int R, int TH, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int r0, int S,
                                           size_t rs, int c0, int w, bool vec) {
  const int wp = (w + 15) & ~15;
  const int l16 = threadIdx.x & 15;
  if (vec) {
    const int c = l16 * 8;
    if (c >= wp) return;
    for (int r = threadIdx.x >> 4; r < R; r += TH / 16) {
      const bool ok = r0 + r < S && c < w;
      tc::cp_async16(dst + r * kLds + c, ok ? src + (size_t)(r0 + r) * rs + c0 + c : src, ok);
    }
  } else {
    for (int r = threadIdx.x >> 4; r < R; r += TH / 16) {
      const bool row_ok = r0 + r < S;
      for (int c = l16; c < wp; c += 16)
        dst[r * kLds + c] = (row_ok && c < w) ? src[(size_t)(r0 + r) * rs + c0 + c]
                                              : tc::T16<T>::round(0.f);
    }
  }
}

// acc[NT] (16 x 8 NT) += A B^T, exact products: A the 16 rows [a_row0,
// +16) of a_tile, B the tile b (NT * 8 rows, the n index), both over
// columns [0, 16 nk) (the k index)
template <int NT, typename T>
__device__ __forceinline__ void mma_nk(float acc[][4], const T* a_tile, int a_row0, const T* b,
                                       int nk) {
  const int lane = threadIdx.x & 31;
  const T* ap = a_tile + (a_row0 + (lane & 15)) * kLds + (lane >> 4) * 8;
  const T* bp = b + ((lane & 7) + ((lane >> 4) << 3)) * kLds + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kDC / 16; ++kk) {
    if (kk < nk) {
      uint32_t a[4];
      tc::ldsm_x4(a, ap + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t f[4];
        tc::ldsm_x4(f, bp + np * 16 * kLds + kk * 16);
        tc::T16<T>::mma(acc[2 * np], a, f[0], f[1]);
        tc::T16<T>::mma(acc[2 * np + 1], a, f[2], f[3]);
      }
    }
  }
}

// x0, x1 scaled by p_scale<T>() as T pairs hi = T(x) and lo = T(x - hi),
// the low column in the low half
template <typename T>
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  x0 *= p_scale<T>();
  x1 *= p_scale<T>();
  hi = tc::T16<T>::pack(x0, x1);
  const float2 hf = tc::T16<T>::unpack(hi);
  lo = tc::T16<T>::pack(x0 - hf.x, x1 - hf.y);
}

// acc[16] (16 x 128) += p_scale<T>() P B: P the 16 x 16 KT accumulator
// fragments p[2 KT] of the score product, split here into hi and lo A
// fragments of T; B the tile b (16 KT rows, the k index) over columns
// [0, 16 ndp) (the n index), its fragments by ldmatrix.trans and used by
// both halves
template <int KT, typename T>
__device__ __forceinline__ void mma_kn(float acc[kDC / 8][4], const float p[][4], const T* b,
                                       int ndp) {
  const int lane = threadIdx.x & 31;
  const T* bp = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLds + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t hi[4], lo[4];
    split_pack<T>(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_pack<T>(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_pack<T>(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_pack<T>(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < kDC / 16; ++dp) {
      if (dp < ndp) {
        uint32_t f[4];
        tc::ldsm_x4_trans(f, bp + kk * 16 * kLds + dp * 16);
        tc::T16<T>::mma(acc[2 * dp], lo, f[0], f[1]);
        tc::T16<T>::mma(acc[2 * dp + 1], lo, f[2], f[3]);
        tc::T16<T>::mma(acc[2 * dp], hi, f[0], f[1]);
        tc::T16<T>::mma(acc[2 * dp + 1], hi, f[2], f[3]);
      }
    }
  }
}

// One online-softmax step over NT n8 score tiles s, scaled to log2 units
// and masked by the caller (rows g and g + 8 of the warp's 16): the
// running max m and sum l of the two rows, s turned into P = 2^(s - m),
// acc rescaled.  l adds the unrounded P.
template <int NT>
__device__ __forceinline__ void softmax_step(float s[][4], float m[2], float l[2],
                                             float acc[kDC / 8][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = exp2_ftz(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(s[nt][e] - m[e >> 1]);
      l[e >> 1] += p;
      s[nt][e] = p;
    }
#pragma unroll
  for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
}

// rows g and g + 8 of a warp's 16 x 128 accumulator times mul[h], rounded
// to T: rows [row0, row0 + 16) of the output (rows rs elements apart),
// columns [c0, c0 + w)
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
        if (c < w) orow[c] = tc::T16<T>::round(acc[nt][2 * h + e] * mul[h]);
      }
  }
}

// dynamic shared memory of the forward at head_dim D, bytes: a ring of K/V
// tiles, then Q (1 tile, or a ring when D > 128); the same for both types
inline size_t fwd_smem(int D) {
  return sizeof(bf16) * kLds *
         (kFwdStages * kFwdStep + 16 * kFwdWarps * (D > kDC ? kFwdStages : 1));
}

// ------------------------------- forward -----------------------------
// One block: query rows [q0, q0 + R) of one head (R = 16 kFwdWarps, a
// warp's 16 rows each; q0 = qt R) against every key to the diagonal,
// output columns [oc0, oc0 + min(kDC, D - oc0)).  q, k, v and o point at
// the head's row 0, rows rs elements apart.  Stages per key tile: one per
// head_dim chunk of Q K^T (K's chunk; Q's too when D > 128, else Q is
// resident), then one of P V (V's output chunk).  Every row has a valid
// key (key 0) in the first tile, so the running max is finite from then
// on; keys past the row, and past S, are -inf.
template <bool kFull, typename T>
__device__ __forceinline__ void forward(const T* __restrict__ qg, const T* __restrict__ kg,
                                        const T* __restrict__ vg, T* __restrict__ og, int S,
                                        int D, size_t rs, int qt, int oc0, float scale, bool vec,
                                        T* smem) {
  constexpr int R = 16 * kFwdWarps, TH = 32 * kFwdWarps, KT = kFwdStep, NS = kFwdStages;
  constexpr int kQSlot = R * kLds, kKSlot = KT * kLds;
  const int nch = (D + kDC - 1) / kDC;
  const int ow = min(kDC, D - oc0);
  T* ring = smem;
  T* qs = ring + NS * kKSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * R;
  const int nkt = min((q0 + R + KT - 1) / KT, (S + KT - 1) / KT);  // to the diagonal
  const int per = nch + 1, nst = nkt * per;
  const float sl2 = scale * kLog2e;

  auto issue = [&](int st) {
    const int kt = st / per, j = st - kt * per, buf = st % NS;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) stage_tile<R, TH>(qs + buf * kQSlot, qg, q0, S, rs, c0, w, vec);
      stage_tile<KT, TH>(ring + buf * kKSlot, kg, kt * KT, S, rs, c0, w, vec);
    } else {
      stage_tile<KT, TH>(ring + buf * kKSlot, vg, kt * KT, S, rs, oc0, ow, vec);
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
    tc::cp_async_wait<NS - 2>();
    __syncthreads();                                // stage st landed, st - 1 done
    if (st + NS - 1 < nst) issue(st + NS - 1);
    tc::cp_async_commit();
    const int kt = st / per, j = st - kt * per, buf = st % NS;
    const T* tile = ring + buf * kKSlot;
    if (j < nch) {                                  // S += Q_j K_j^T
      if (j == 0) zero<KT / 8>(s);
      mma_nk<KT / 8>(s, qs + (nch > 1 ? buf : 0) * kQSlot, warp * 16, tile,
                     ksteps<kFull>(min(kDC, D - j * kDC)));
      continue;
    }
    const int k0 = kt * KT;
    const bool diag = k0 + KT > q0 + 1;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = s[nt][e] * sl2;
        s[nt][e] = diag && (c > r || c >= S) ? -INFINITY : x;
      }
    softmax_step<KT / 8>(s, m, l, acc);
    mma_kn<KT / 16>(acc, s, tile, ksteps<kFull>(ow));   // O += (hi + lo) V
  }
  tc::cp_async_wait<0>();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = p_unscale<T>() / quad_sum(l[h]);
  store_rows(og, acc, q0 + warp * 16, S, rs, oc0, ow, inv);
}

}  // namespace attn16
