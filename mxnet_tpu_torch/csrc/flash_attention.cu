// Causal flash attention for Hopper (sm_90a), forward and backward, in
// f32, bf16 or f16, any S and any head_dim, plain C interface.
//
// Replaces mxnet_tpu/ops/nn.py:744 _flash_attention, which calls jax's
// library Pallas kernel for the TPU (jax/experimental/pallas/ops/tpu/
// flash_attention.py, with its own VJP): the forward pallas_call (:758)
// and the two backward ones, dK/dV (:1121) and dQ (:1456).  Inputs are
// contiguous head-major (B, H, S, D) of one element type (float,
// __nv_bfloat16 or __half), any S and any D; the kernels
// mask the ragged last tile themselves, so the TPU's head_dim % 128 and
// seq % 512 gates do not carry over.  The log-sum-exp L and Dr = rowsum(dO * O) are f32.
//
//   mx_flash_fwd:     O = softmax(Q K^T * scale, causal) V, and the
//                     per-row log-sum-exp L.
//   mx_flash_bwd_dkv: P = exp(Q K^T * scale - L) recomputed, then
//                     dV = P^T dO and dK = (P * (dO V^T - Dr) * scale)^T Q,
//                     where Dr = rowsum(dO * O) comes in precomputed.
//   mx_flash_bwd_dq:  dQ = (P * (dO V^T - Dr) * scale) K.
//
// Numerics follow the TPU kernel: every product sums in f32; P (the
// exponentials exp(s - m) of the forward, exp(s - L) of the backward)
// and dS are rounded to the input type before the products that consume
// them (p.astype(v.dtype), ds.astype(q.dtype) in the jax kernel), while
// the softmax sum l adds the unrounded P in f32; outputs are rounded
// once, at the end.  In f32 the roundings are the identity.  The kernels
// stay two for the backward, as on the TPU: no atomics, so every result
// is deterministic.
//
// What bounds them on the H100.  One causal product over the lower
// triangle is B*H*S*(S+1)/2*D multiply-adds; the forward does two, dK/dV
// four and dQ three, over 4, 6 and 5 arrays of (B, H, S, D).  At the
// bf16 training shape (4, 16, 1024, 128), on the tensor cores' dense
// 989 TFLOP/s and 3.35 TB/s, the forward is bound by bytes (20.1 us of
// memory against 17.4 us of products), dK/dV and dQ by operations (34.8
// and 26.1 us against 30.2 and 25.2 us of memory).  In f32 all three are
// bound by operations, on the CUDA cores (67 TFLOP/s) and in split TF32
// on the tensor cores alike (attention_f32.cuh).
//
// bf16 design (mma.sync, FlashAttention-2's shape).  Every product is
// mma.sync.m16n8k16 with bf16 operands and f32 sums.  Tiles stay bf16 in
// shared memory, rows padded by 8 elements (a 272-byte stride puts the 8
// rows an ldmatrix reads on 8 distinct groups of 4 banks); ldmatrix
// feeds the operands, .trans for those read along the other axis (V in
// P V, dO and Q in the backward's P^T dO and dS^T Q, K in dS K).  The
// accumulator fragment of two adjacent n8 score tiles is, converted to
// bf16, the A fragment of an m16k16 product, so P and dS go from the
// score product to the next one in registers and never touch shared
// memory.  A block of 128 threads (4 warps) takes 64 query rows (forward,
// dQ; a warp owns 16 rows and walks key tiles of 64 up to the diagonal)
// or 64 keys (dK/dV; a warp owns 16 keys and walks query tiles of 32 from
// the diagonal: the dK and dV accumulators take 128 registers, so the
// score tile is kept at 16 x 32).  Copies are 16-byte cp.async into a
// ring of two stages: a block's work is a sequence of stages (one per key or
// query tile, or per 128-column chunk of head_dim when D > 128), and the
// next stage's copy is issued before the current stage's products, so
// each copy overlaps one stage of tensor-core work, behind one
// __syncthreads per stage.  The forward's stages alternate K and V
// tiles, so V's copy overlaps Q K^T and the next K's copy overlaps P V.
// Causal loops stop at the diagonal, and only the diagonal tiles (and a
// ragged last tile) mask.  Ragged S: rows past S are zero-filled by the
// copy (cp.async with a source size of 0), and scores past S are -inf (P
// = 0).  Head_dim: chunks of 128 columns, so shared memory does not grow
// with D; the grid's third dimension walks the output chunks and the
// score products sum over every chunk, each staged in turn (at D <= 128
// the resident operand is staged once).  A ragged chunk is zero-padded
// in shared memory to a multiple of 16 columns, so the padding adds
// nothing to a product; when D % 8 != 0 (or a pointer is not 16-byte
// aligned) rows are not 16-byte aligned and the same kernel copies
// element by element.  When every chunk is full (D % 128 == 0) the
// kernels are instantiated with compile-time step counts, so the product
// loops carry no branch and ptxas issues each step's ldmatrix loads
// ahead of its mma (the ragged form, with a branch per step, ran 20-50%
// slower at D = 128).  Exponentials are ex2.approx of scores pre-scaled
// by scale * log2(e).  Query tiles run longest first: the grid's x is
// batch * head and y the tile, so the first wave holds the longest tiles
// of every head (tile-major order ran 11-16% slower).  The per-kernel
// sizes below were tuned on an H100 (tools/torch_flash_tune.py times the
// variants): 8 warps a block, 32-row steps and rings of 3 or 4 stages
// were no faster; the forward holds 3 blocks an SM (at 4 blocks ptxas
// caps it at 128 registers and spills).
//
// f16: the bf16 kernels, templates over their element type (tc::T16:
// the .f16 mma opcode, f16 packing and rounding), f32 sums.  P enters
// P V and P^T dO, and dS enters dS^T Q and dS K, as one f16 term each,
// as the plain version rounds them (kernels/flash_attention.py,
// _rounded) and as the reference's f16 path rounds P
// (mxnet_tpu/ops/nn.py:799, softmax(s).astype(qkv.dtype)); dP and every
// sum stay f32 (the reference's f16 autodiff also rounds dP and the
// scores: the port keeps them f32).  P <= 1 rounds to f16 with 11 bits
// down to 2^-14, and smaller P, subnormal or flushed, weigh under 2^-14
// of the row's largest: no scaling.  dS carries the loss scale: where
// |dS| passes 65504 it rounds to inf (cvt.rn, not a saturating
// conversion), as in the plain version, so the step's gradients go
// non-finite and the loss scaler skips it; below 2^-14 dS goes
// subnormal and below 2^-24 it flushes, at the same points as there.
//
// f32 design (tensor cores, split TF32): the f32 kernels are built from
// attention_f32.cuh (design note there), the bf16 kernels' shape with
// every product in 3xTF32 (three mma.sync m16n8k8 of hi/lo halves), f32
// tiles in shared memory and expf / logf, so they hold the f32
// tolerance against the plain version.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "tc_mma.cuh"

namespace {
constexpr int kDC = 128;                     // head_dim columns per chunk
}  // namespace

// ---------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 sums; helpers in tc_mma.cuh)
// ---------------------------------------------------------------------
namespace tc {

// Per kernel: warps a block (each owns 16 query rows, or 16 keys in
// dK/dV), blocks an SM should hold (a register budget for ptxas), rows of
// the tile a stage walks (keys, or query rows in dK/dV) and stages of the
// cp.async ring.
constexpr int kFwdWarps = 4, kFwdMinBlocks = 3, kFwdStep = 64, kFwdStages = 2;
constexpr int kDkvWarps = 4, kDkvMinBlocks = 1, kDkvStep = 32, kDkvStages = 2;
constexpr int kDqWarps = 4, kDqMinBlocks = 1, kDqStep = 64, kDqStages = 2;
constexpr int kLds = kDC + 8;                // smem row stride, elements (272 bytes)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (ex2.approx.ftz: relative error ~2^-22, results below 2^-126
// flush to 0, far under a 16-bit P's resolution and the sum l's)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [r0, r0 + R), columns [c0, c0 + w) of a (S, D) matrix into
// an (R, kLds) tile of T (bf16 or f16), zero rows past S and columns [w, w
// rounded up to 16).  vec: 16-byte cp.async (D % 8 == 0 and the base
// aligned, so w is a multiple of 8); else element by element, made
// visible by the __syncthreads that starts the stage which reads the tile.
template <int R, int TH, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int r0, int S,
                                           int D, int c0, int w, bool vec) {
  const int wp = (w + 15) & ~15;
  const int l16 = threadIdx.x & 15;
  if (vec) {
    const int c = l16 * 8;
    if (c >= wp) return;
    for (int r = threadIdx.x >> 4; r < R; r += TH / 16) {
      const bool ok = r0 + r < S && c < w;
      cp_async16(dst + r * kLds + c, ok ? src + (size_t)(r0 + r) * D + c0 + c : src, ok);
    }
  } else {
    for (int r = threadIdx.x >> 4; r < R; r += TH / 16) {
      const bool row_ok = r0 + r < S;
      for (int c = l16; c < wp; c += 16)
        dst[r * kLds + c] = (row_ok && c < w) ? src[(size_t)(r0 + r) * D + c0 + c]
                                              : T16<T>::round(0.f);
    }
  }
}

// acc[NT] (16 x 8 NT) += A B^T: A the 16 rows [a_row0, +16) of a_tile,
// B the tile b (NT * 8 rows, the n index), both over columns
// [0, 16 nk) (the k index)
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
      ldsm_x4(a, ap + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t f[4];
        ldsm_x4(f, bp + np * 16 * kLds + kk * 16);
        T16<T>::mma(acc[2 * np], a, f[0], f[1]);
        T16<T>::mma(acc[2 * np + 1], a, f[2], f[3]);
      }
    }
  }
}

// acc[16] (16 x 128) += P B: P the 16 x 16 KT accumulator fragments
// p[2 KT] of an earlier product, rounded to T here (one term: the TPU
// kernel's p.astype(v.dtype)); B the tile b (16 KT rows, the k index) over
// columns [0, 16 ndp) (the n index)
template <int KT, typename T>
__device__ __forceinline__ void mma_kn(float acc[16][4], const float p[][4], const T* b,
                                       int ndp) {
  const int lane = threadIdx.x & 31;
  const T* bp = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLds + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {T16<T>::pack(p[2 * kk][0], p[2 * kk][1]),
                           T16<T>::pack(p[2 * kk][2], p[2 * kk][3]),
                           T16<T>::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           T16<T>::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < kDC / 16; ++dp) {
      if (dp < ndp) {
        uint32_t f[4];
        ldsm_x4_trans(f, bp + kk * 16 * kLds + dp * 16);
        T16<T>::mma(acc[2 * dp], a, f[0], f[1]);
        T16<T>::mma(acc[2 * dp + 1], a, f[2], f[3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float a[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// rows g and g + 8 of a warp's 16 x 128 accumulator, rounded to T:
// rows [row0, row0 + 16) of the (S, D) output, columns [c0, c0 + w)
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float acc[16][4],
                                           int row0, int S, int D, int c0, int w,
                                           const float mul[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= S) continue;
    T* orow = out + (size_t)r * D + c0;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        if (c < w) orow[c] = T16<T>::round(acc[nt][2 * h + e] * mul[h]);
      }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16-column steps over a chunk of width w: all 8 when every chunk is
// full (D % 128 == 0, a compile-time count, so the product loops carry
// no branch and ptxas can batch their ldmatrix), else w rounded up
template <bool kFull>
__device__ __forceinline__ int ksteps(int w) {
  return kFull ? kDC / 16 : (w + 15) >> 4;
}

// -------------------------------- forward ----------------------------
// Stages per key tile: one per head_dim chunk of Q K^T (K chunk; Q chunk
// too when D > 128, else Q is resident), then one of P V (V's output
// chunk).  Shared memory: a ring of K/V tiles, then Q (1 tile, or a ring
// when D > 128).  T is bf16 or f16, as in the backward kernels below.
template <typename T, bool kFull>
__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
flash_fwd16_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int S, int D, float scale,
                   int vec) {
  constexpr int R = 16 * kFwdWarps, TH = 32 * kFwdWarps, KT = kFwdStep, NS = kFwdStages;
  constexpr int kQSlot = R * kLds, kKSlot = KT * kLds;
  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - (int)blockIdx.y;          // longest rows first
  const size_t bh = blockIdx.x;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const T* qg = q + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
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
      if (nch > 1) stage_tile<R, TH>(qs + buf * kQSlot, qg, q0, S, D, c0, w, vec);
      stage_tile<KT, TH>(ring + buf * kKSlot, kg, kt * KT, S, D, c0, w, vec);
    } else {
      stage_tile<KT, TH>(ring + buf * kKSlot, vg, kt * KT, S, D, oc0, ow, vec);
    }
  };
  if (nch == 1) stage_tile<R, TH>(qs, qg, q0, S, D, 0, D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }

  float s[KT / 8][4], acc[kDC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // rows g, g + 8
  zero<kDC / 8>(acc);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();                                // stage st landed, st - 1 done
    if (st + NS - 1 < nst) issue(st + NS - 1);
    cp_async_commit();
    const int kt = st / per, j = st - kt * per, buf = st % NS;
    const T* tile = ring + buf * kKSlot;
    if (j < nch) {                                  // S += Q_j K_j^T
      if (j == 0) zero<KT / 8>(s);
      const int w = min(kDC, D - j * kDC);
      mma_nk<KT / 8>(s, qs + (nch > 1 ? buf : 0) * kQSlot, warp * 16, tile, ksteps<kFull>(w));
      continue;
    }
    // online softmax in log2 units; on the tiles that cross the diagonal
    // keys past the row (and past S) are -inf.  Every row has a valid
    // key in the first tile, so m is finite from then on.
    const int k0 = kt * KT;
    const bool diag = k0 + KT > q0 + 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * sl2;
        if (diag && (c > r || c >= S)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2_ftz(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;                             // unrounded
        s[nt][e] = p;
      }
#pragma unroll
    for (int nt = 0; nt < kDC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    mma_kn<KT / 16>(acc, s, tile, ksteps<kFull>(ow));  // O += T(P) V
  }
  cp_async_wait<0>();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
  }
  const int row0 = q0 + warp * 16;
  store_rows(o + bh * S * D, acc, row0, S, D, oc0, ow, inv);
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      if (r < S) lse[bh * S + r] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

// -------------------------------- dK/dV ------------------------------
// A warp owns 16 keys; the block walks query tiles of QT rows from the
// diagonal.  Stages per query tile: one per head_dim chunk of S^T = K
// Q^T and dP^T = V dO^T (Q and dO chunks; K and V chunks too when D >
// 128, else K and V are resident), and when D > 128 one more for the
// output chunk of Q and dO.  The stage that forms P^T and dS^T also
// stages L and Dr of its rows.  Shared memory: rings of Q and dO tiles,
// of L and of Dr, then K and V (1 tile each, or rings).
template <typename T, bool kFull>
__global__ void __launch_bounds__(32 * kDkvWarps, kDkvMinBlocks)
flash_bwd_dkv16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, int S, int D, float scale,
                       int vec) {
  constexpr int R = 16 * kDkvWarps, TH = 32 * kDkvWarps, QT = kDkvStep, NS = kDkvStages;
  constexpr int kKSlot = R * kLds, kQSlot = QT * kLds;
  const int kt = blockIdx.y;                        // most query tiles first
  const size_t bh = blockIdx.x;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const T* qg = q + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  const T* dog = dout + bh * S * D;
  const float* lg = lse + bh * S;
  const float* dg = delta + bh * S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);               // NS Q tiles
  T* dos = qs + NS * kQSlot;                        // NS dO tiles
  float* ls = reinterpret_cast<float*>(dos + NS * kQSlot);  // NS x QT
  float* drs = ls + NS * QT;                        // NS x QT
  T* ks = reinterpret_cast<T*>(drs + NS * QT);
  T* vs = ks + (nch > 1 ? NS : 1) * kKSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kt * R;
  const int first = k0 / QT, nqt = (S + QT - 1) / QT;
  const int per = nch == 1 ? 1 : nch + 1, nst = (nqt - first) * per;
  const float sl2 = scale * kLog2e;

  auto issue = [&](int st) {
    const int qi = first + st / per, j = st % per, buf = st % NS, q0 = qi * QT;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) {
        stage_tile<R, TH>(ks + buf * kKSlot, kg, k0, S, D, c0, w, vec);
        stage_tile<R, TH>(vs + buf * kKSlot, vg, k0, S, D, c0, w, vec);
      }
      stage_tile<QT, TH>(qs + buf * kQSlot, qg, q0, S, D, c0, w, vec);
      stage_tile<QT, TH>(dos + buf * kQSlot, dog, q0, S, D, c0, w, vec);
    } else {
      stage_tile<QT, TH>(qs + buf * kQSlot, qg, q0, S, D, oc0, ow, vec);
      stage_tile<QT, TH>(dos + buf * kQSlot, dog, q0, S, D, oc0, ow, vec);
    }
    if (j == per - 1) {
      const int i = threadIdx.x % QT, r = q0 + i;
      if (threadIdx.x < QT)
        cp_async4(ls + buf * QT + i, r < S ? lg + r : lg, r < S);
      else if (threadIdx.x < 2 * QT)
        cp_async4(drs + buf * QT + i, r < S ? dg + r : dg, r < S);
    }
  };
  if (nch == 1) {
    stage_tile<R, TH>(ks, kg, k0, S, D, 0, D, vec);
    stage_tile<R, TH>(vs, vg, k0, S, D, 0, D, vec);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }

  float sT[QT / 8][4], dpT[QT / 8][4], adk[kDC / 8][4], adv[kDC / 8][4];
  zero<kDC / 8>(adk);
  zero<kDC / 8>(adv);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (st + NS - 1 < nst) issue(st + NS - 1);
    cp_async_commit();
    const int qi = first + st / per, j = st % per, buf = st % NS, q0 = qi * QT;
    const T* qt_ = qs + buf * kQSlot;
    const T* dot_ = dos + buf * kQSlot;
    if (j < nch) {                                  // S^T, dP^T over chunk j
      if (j == 0) {
        zero<QT / 8>(sT);
        zero<QT / 8>(dpT);
      }
      const int w = min(kDC, D - j * kDC), nk = ksteps<kFull>(w);
      const int rb = nch > 1 ? buf : 0;
      mma_nk<QT / 8>(sT, ks + rb * kKSlot, warp * 16, qt_, nk);
      mma_nk<QT / 8>(dpT, vs + rb * kKSlot, warp * 16, dot_, nk);
      if (nch > 1) continue;
    }
    // P^T = exp(S^T scale - L), dS^T = P^T (dP^T - Dr) scale; masked on
    // the tiles that cross the diagonal or pass S
    const bool masked = q0 < k0 + R || q0 + QT > S;
    const float* lb = ls + buf * QT;
    const float* db = drs + buf * QT;
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + (e >> 1) * 8;
        const int qc = nt * 8 + 2 * t + (e & 1), r = q0 + qc;
        const bool ok = !masked || (key <= r && r < S);
        const float p = ok ? exp2_ftz(sT[nt][e] * sl2 - lb[qc] * kLog2e) : 0.f;
        dpT[nt][e] = p * (dpT[nt][e] - db[qc]) * scale;
        sT[nt][e] = p;
      }
    const int ndp = ksteps<kFull>(ow);
    mma_kn<QT / 16>(adv, sT, dot_, ndp);            // dV += T(P^T) dO
    mma_kn<QT / 16>(adk, dpT, qt_, ndp);            // dK += T(dS^T) Q
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows(dk + bh * S * D, adk, k0 + warp * 16, S, D, oc0, ow, one);
  store_rows(dv + bh * S * D, adv, k0 + warp * 16, S, D, oc0, ow, one);
}

// -------------------------------- dQ ---------------------------------
// A warp owns 16 query rows; the block walks key tiles of KT to the
// diagonal.  Stages per key tile: one per head_dim chunk of S = Q K^T
// and dP = dO V^T (K and V chunks; Q and dO chunks too when D > 128,
// else Q and dO are resident), and when D > 128 one more for K's output
// chunk.  Shared memory: rings of K and V tiles, then Q and dO (1 tile
// each, or rings).
template <typename T, bool kFull>
__global__ void __launch_bounds__(32 * kDqWarps, kDqMinBlocks)
flash_bwd_dq16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dq, int S, int D, float scale, int vec) {
  constexpr int R = 16 * kDqWarps, TH = 32 * kDqWarps, KT = kDqStep, NS = kDqStages;
  constexpr int kQSlot = R * kLds, kKSlot = KT * kLds;
  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - (int)blockIdx.y;          // longest rows first
  const size_t bh = blockIdx.x;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const T* qg = q + bh * S * D;
  const T* kg = k + bh * S * D;
  const T* vg = v + bh * S * D;
  const T* dog = dout + bh * S * D;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);               // NS key tiles
  T* vs = ks + NS * kKSlot;                         // NS key tiles
  T* qs = vs + NS * kKSlot;
  T* dos = qs + (nch > 1 ? NS : 1) * kQSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * R;
  const int nkt = min((q0 + R + KT - 1) / KT, (S + KT - 1) / KT);  // to the diagonal
  const int per = nch == 1 ? 1 : nch + 1, nst = nkt * per;
  const float sl2 = scale * kLog2e;

  auto issue = [&](int st) {
    const int kt = st / per, j = st % per, buf = st % NS;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) {
        stage_tile<R, TH>(qs + buf * kQSlot, qg, q0, S, D, c0, w, vec);
        stage_tile<R, TH>(dos + buf * kQSlot, dog, q0, S, D, c0, w, vec);
      }
      stage_tile<KT, TH>(ks + buf * kKSlot, kg, kt * KT, S, D, c0, w, vec);
      stage_tile<KT, TH>(vs + buf * kKSlot, vg, kt * KT, S, D, c0, w, vec);
    } else {
      stage_tile<KT, TH>(ks + buf * kKSlot, kg, kt * KT, S, D, oc0, ow, vec);
    }
  };
  if (nch == 1) {
    stage_tile<R, TH>(qs, qg, q0, S, D, 0, D, vec);
    stage_tile<R, TH>(dos, dog, q0, S, D, 0, D, vec);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }

  float lr[2], dr[2];                               // rows g, g + 8 (log2 units)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    lr[h] = r < S ? lse[bh * S + r] * kLog2e : 0.f;
    dr[h] = r < S ? delta[bh * S + r] : 0.f;
  }
  float s[KT / 8][4], dp[KT / 8][4], acc[kDC / 8][4];
  zero<kDC / 8>(acc);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (st + NS - 1 < nst) issue(st + NS - 1);
    cp_async_commit();
    const int kt = st / per, j = st % per, buf = st % NS;
    if (j < nch) {                                  // S, dP over chunk j
      if (j == 0) {
        zero<KT / 8>(s);
        zero<KT / 8>(dp);
      }
      const int w = min(kDC, D - j * kDC), nk = ksteps<kFull>(w);
      const int rb = nch > 1 ? buf : 0;
      mma_nk<KT / 8>(s, qs + rb * kQSlot, warp * 16, ks + buf * kKSlot, nk);
      mma_nk<KT / 8>(dp, dos + rb * kQSlot, warp * 16, vs + buf * kKSlot, nk);
      if (nch > 1) continue;
    }
    // dS = P (dP - Dr) scale, P = exp(S scale - L); keys past the row
    // (and past S) masked on the tiles that cross the diagonal
    const int k0 = kt * KT;
    const bool diag = k0 + KT > q0 + 1;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = !diag || (c <= r && c < S);
        const float p = ok ? exp2_ftz(s[nt][e] * sl2 - lr[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dr[e >> 1]) * scale;
      }
    mma_kn<KT / 16>(acc, dp, ks + buf * kKSlot, ksteps<kFull>(ow));  // dQ += T(dS) K
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows(dq + bh * S * D, acc, q0 + warp * 16, S, D, oc0, ow, one);
}

size_t fwd_smem(int D) {
  return sizeof(bf16) * kLds *
         (kFwdStages * kFwdStep + 16 * kFwdWarps * (D > kDC ? kFwdStages : 1));
}
size_t dkv_smem(int D) {
  return sizeof(bf16) * kLds *
             (2 * kDkvStages * kDkvStep + 16 * kDkvWarps * 2 * (D > kDC ? kDkvStages : 1)) +
         sizeof(float) * 2 * kDkvStages * kDkvStep;
}
size_t dq_smem(int D) {
  return sizeof(bf16) * kLds *
         (2 * kDqStages * kDqStep + 16 * kDqWarps * 2 * (D > kDC ? kDqStages : 1));
}

// x: batch * head, y: tiles of 16 * warps rows (or keys), z: head_dim chunks
dim3 grid_of(int BH, int S, int D, int warps) {
  return dim3(BH, (S + 16 * warps - 1) / (16 * warps), (D + kDC - 1) / kDC);
}

}  // namespace tc

// ---------------------------------------------------------------------
// f32: tensor cores in split TF32 (attention_f32.cuh)
// ---------------------------------------------------------------------
namespace attn32 {

// -------------------------------- forward ----------------------------
template <bool kFull>
__global__ void __launch_bounds__(32 * kFwdWarps, kFwdMinBlocks)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale, int vec) {
  const int nq = (S + 16 * kFwdWarps - 1) / (16 * kFwdWarps);
  const int qt = nq - 1 - (int)blockIdx.y;          // longest rows first
  const size_t bh = blockIdx.x, off = bh * S * D;
  extern __shared__ __align__(16) unsigned char smem[];
  forward<kFull>(q + off, k + off, v + off, o + off, blockIdx.z == 0 ? lse + bh * S : nullptr,
                 S, D, (size_t)D, qt, (int)blockIdx.z * kDC, scale, vec,
                 reinterpret_cast<float*>(smem));
}

// -------------------------------- dK/dV ------------------------------
// A warp owns 16 keys; the block walks query tiles of QT rows from the
// diagonal.  Stages per query tile: one per head_dim chunk of S^T = K
// Q^T and dP^T = V dO^T (Q and dO chunks; K and V chunks too when D >
// 128, else K and V are resident), and when D > 128 one more for the
// output chunk of Q and dO.  The stage that forms P^T and dS^T also
// stages L and Dr of its rows.  Q and dO (B operands of every product
// here) are split as they land; K and V (A operands) at each fragment
// load.  Shared memory: rings of split Q and dO tiles, of L and of Dr,
// then K and V (1 tile each, or rings).
template <bool kFull, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int D,
                         float scale, int vec) {
  constexpr int R = 16 * kWarps, TH = 32 * kWarps, QT = kDkvStep, NS = kDkvStages;
  constexpr int kKSlot = R * kLd, kQSlot = QT * kLd;   // ring slots: 2 kQSlot
  const int kt = blockIdx.y;                        // most query tiles first
  const size_t bh = blockIdx.x;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const float* qg = q + bh * S * D;
  const float* kg = k + bh * S * D;
  const float* vg = v + bh * S * D;
  const float* dog = dout + bh * S * D;
  const float* lg = lse + bh * S;
  const float* dg = delta + bh * S;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);       // NS split Q tiles
  float* dos = qs + NS * 2 * kQSlot;                // NS split dO tiles
  float* ls = dos + NS * 2 * kQSlot;                // NS x QT
  float* drs = ls + NS * QT;                        // NS x QT
  float* ks = drs + NS * QT;
  float* vs = ks + (nch > 1 ? NS : 1) * kKSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kt * R;
  const int first = k0 / QT, nqt = (S + QT - 1) / QT;
  const int per = nch == 1 ? 1 : nch + 1, nst = (nqt - first) * per;

  auto issue = [&](int st) {
    const int qi = first + st / per, j = st % per, buf = st % NS, q0 = qi * QT;
    const int c0 = j < nch ? j * kDC : oc0, w = min(kDC, D - c0);
    if (j < nch && nch > 1) {
      stage_tile<R, TH>(ks + buf * kKSlot, kg, k0, S, (size_t)D, c0, w, vec);
      stage_tile<R, TH>(vs + buf * kKSlot, vg, k0, S, (size_t)D, c0, w, vec);
    }
    stage_tile<QT, TH>(qs + buf * 2 * kQSlot, qg, q0, S, (size_t)D, c0, w, vec);
    stage_tile<QT, TH>(dos + buf * 2 * kQSlot, dog, q0, S, (size_t)D, c0, w, vec);
    if (j == per - 1) {
      const int i = threadIdx.x % QT, r = q0 + i;
      if (threadIdx.x < QT)
        tc::cp_async4(ls + buf * QT + i, r < S ? lg + r : lg, r < S);
      else if (threadIdx.x < 2 * QT)
        tc::cp_async4(drs + buf * QT + i, r < S ? dg + r : dg, r < S);
    }
  };
  if (nch == 1) {
    stage_tile<R, TH>(ks, kg, k0, S, (size_t)D, 0, D, vec);
    stage_tile<R, TH>(vs, vg, k0, S, (size_t)D, 0, D, vec);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }

  float sT[QT / 8][4], dpT[QT / 8][4], adk[kDC / 8][4], adv[kDC / 8][4];
  zero<kDC / 8>(adk);
  zero<kDC / 8>(adv);
  for (int st = 0; st < nst; ++st) {
    const int qi = first + st / per, j = st % per, buf = st % NS, q0 = qi * QT;
    float* qt_ = qs + buf * 2 * kQSlot;
    float* dot_ = dos + buf * 2 * kQSlot;
    tc::cp_async_wait<NS - 2>();
    const int wj = min(kDC, D - (j < nch ? j * kDC : oc0));
    split_tile<QT, TH>(qt_, qt_ + kQSlot, wj, vec);
    split_tile<QT, TH>(dot_, dot_ + kQSlot, wj, vec);
    __syncthreads();
    if (st + NS - 1 < nst) issue(st + NS - 1);
    tc::cp_async_commit();
    if (j < nch) {                                  // S^T, dP^T over chunk j
      if (j == 0) {
        zero<QT / 8>(sT);
        zero<QT / 8>(dpT);
      }
      const int nk = ksteps<kFull>(wj);
      const int rb = nch > 1 ? buf : 0;
      mma_nk<QT / 8>(sT, ks + rb * kKSlot, warp * 16, qt_, qt_ + kQSlot, nk);
      mma_nk<QT / 8>(dpT, vs + rb * kKSlot, warp * 16, dot_, dot_ + kQSlot, nk);
      if (nch > 1) continue;
    }
    // P^T = exp(S^T scale - L), dS^T = P^T (dP^T - Dr) scale; masked on
    // the tiles that cross the diagonal or pass S
    const bool masked = q0 < k0 + R || q0 + QT > S;
    const float* lb = ls + buf * QT;
    const float* db = drs + buf * QT;
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + (e >> 1) * 8;
        const int qc = nt * 8 + 2 * t + (e & 1), r = q0 + qc;
        const bool ok = !masked || (key <= r && r < S);
        const float p = ok ? expf(sT[nt][e] * scale - lb[qc]) : 0.f;
        dpT[nt][e] = p * (dpT[nt][e] - db[qc]) * scale;
        sT[nt][e] = p;
      }
    const int ndp = ksteps<kFull>(ow);
    mma_kn<QT / 8>(adv, sT, dot_, dot_ + kQSlot, ndp);   // dV += P^T dO
    mma_kn<QT / 8>(adk, dpT, qt_, qt_ + kQSlot, ndp);    // dK += dS^T Q
  }
  tc::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows(dk + bh * S * D, adk, k0 + warp * 16, S, (size_t)D, oc0, ow, one);
  store_rows(dv + bh * S * D, adv, k0 + warp * 16, S, (size_t)D, oc0, ow, one);
}

// -------------------------------- dQ ---------------------------------
// A warp owns 16 query rows; the block walks key tiles of KT to the
// diagonal.  Stages per key tile: one per head_dim chunk of S = Q K^T
// and dP = dO V^T (K and V chunks; Q and dO chunks too when D > 128,
// else Q and dO are resident), and when D > 128 one more for K's output
// chunk.  K and V (B operands) are split as they land, Q and dO at each
// fragment load.  Shared memory: rings of split K and V tiles, then Q
// and dO (1 tile each, or rings).
template <bool kFull, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int D, float scale, int vec) {
  constexpr int R = 16 * kWarps, TH = 32 * kWarps, KT = kDqStep, NS = kDqStages;
  constexpr int kQSlot = R * kLd, kKSlot = KT * kLd;   // ring slots: 2 kKSlot
  const int nq = (S + R - 1) / R;
  const int qt = nq - 1 - (int)blockIdx.y;          // longest rows first
  const size_t bh = blockIdx.x;
  const int nch = (D + kDC - 1) / kDC;
  const int oc0 = blockIdx.z * kDC, ow = min(kDC, D - oc0);
  const float* qg = q + bh * S * D;
  const float* kg = k + bh * S * D;
  const float* vg = v + bh * S * D;
  const float* dog = dout + bh * S * D;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);       // NS split key tiles
  float* vs = ks + NS * 2 * kKSlot;                 // NS split key tiles
  float* qs = vs + NS * 2 * kKSlot;
  float* dos = qs + (nch > 1 ? NS : 1) * kQSlot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * R;
  const int nkt = min((q0 + R + KT - 1) / KT, (S + KT - 1) / KT);  // to the diagonal
  const int per = nch == 1 ? 1 : nch + 1, nst = nkt * per;

  auto issue = [&](int st) {
    const int kt = st / per, j = st % per, buf = st % NS;
    if (j < nch) {
      const int c0 = j * kDC, w = min(kDC, D - c0);
      if (nch > 1) {
        stage_tile<R, TH>(qs + buf * kQSlot, qg, q0, S, (size_t)D, c0, w, vec);
        stage_tile<R, TH>(dos + buf * kQSlot, dog, q0, S, (size_t)D, c0, w, vec);
      }
      stage_tile<KT, TH>(ks + buf * 2 * kKSlot, kg, kt * KT, S, (size_t)D, c0, w, vec);
      stage_tile<KT, TH>(vs + buf * 2 * kKSlot, vg, kt * KT, S, (size_t)D, c0, w, vec);
    } else {
      stage_tile<KT, TH>(ks + buf * 2 * kKSlot, kg, kt * KT, S, (size_t)D, oc0, ow, vec);
    }
  };
  if (nch == 1) {
    stage_tile<R, TH>(qs, qg, q0, S, (size_t)D, 0, D, vec);
    stage_tile<R, TH>(dos, dog, q0, S, (size_t)D, 0, D, vec);
  }
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    tc::cp_async_commit();
  }

  float lr[2], dr[2];                               // rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    lr[h] = r < S ? lse[bh * S + r] : 0.f;
    dr[h] = r < S ? delta[bh * S + r] : 0.f;
  }
  float s[KT / 8][4], dp[KT / 8][4], acc[kDC / 8][4];
  zero<kDC / 8>(acc);
  for (int st = 0; st < nst; ++st) {
    const int kt = st / per, j = st % per, buf = st % NS;
    float* kt_ = ks + buf * 2 * kKSlot;
    float* vt_ = vs + buf * 2 * kKSlot;
    tc::cp_async_wait<NS - 2>();
    const int wj = j < nch ? min(kDC, D - j * kDC) : ow;
    split_tile<KT, TH>(kt_, kt_ + kKSlot, wj, vec);
    if (j < nch) split_tile<KT, TH>(vt_, vt_ + kKSlot, wj, vec);
    __syncthreads();
    if (st + NS - 1 < nst) issue(st + NS - 1);
    tc::cp_async_commit();
    if (j < nch) {                                  // S, dP over chunk j
      if (j == 0) {
        zero<KT / 8>(s);
        zero<KT / 8>(dp);
      }
      const int nk = ksteps<kFull>(wj);
      const int rb = nch > 1 ? buf : 0;
      mma_nk<KT / 8>(s, qs + rb * kQSlot, warp * 16, kt_, kt_ + kKSlot, nk);
      mma_nk<KT / 8>(dp, dos + rb * kQSlot, warp * 16, vt_, vt_ + kKSlot, nk);
      if (nch > 1) continue;
    }
    // dS = P (dP - Dr) scale, P = exp(S scale - L); keys past the row
    // (and past S) masked on the tiles that cross the diagonal
    const int k0 = kt * KT;
    const bool diag = k0 + KT > q0 + 1;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + warp * 16 + g + (e >> 1) * 8;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = !diag || (c <= r && c < S);
        const float p = ok ? expf(s[nt][e] * scale - lr[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dr[e >> 1]) * scale;
      }
    mma_kn<KT / 8>(acc, dp, kt_, kt_ + kKSlot, ksteps<kFull>(ow));  // dQ += dS K
  }
  tc::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows(dq + bh * S * D, acc, q0 + warp * 16, S, (size_t)D, oc0, ow, one);
}

// warps of the dK/dV and dQ blocks at head_dim D
inline int dkv_warps(int D) { return D > kDC ? kDkvWideWarps : kDkvWarps; }
inline int dq_warps(int D) { return D > kDC ? kDqWideWarps : kDqWarps; }

size_t dkv_smem(int D) {
  const int rows = 16 * dkv_warps(D);
  return sizeof(float) * kLd *
             (2 * kDkvStages * 2 * kDkvStep + rows * 2 * (D > kDC ? kDkvStages : 1)) +
         sizeof(float) * 2 * kDkvStages * kDkvStep;
}
size_t dq_smem(int D) {
  const int rows = 16 * dq_warps(D);
  return sizeof(float) * kLd *
         (2 * kDqStages * 2 * kDqStep + rows * 2 * (D > kDC ? kDqStages : 1));
}

}  // namespace attn32

namespace {

template <typename F>
cudaError_t prepare(F fn, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
            int D, float scale, int device, void* stream) {
  const size_t smem = attn32::fwd_smem(D);
  const auto kernel = D % kDC == 0 ? attn32::flash_fwd_f32_kernel<true>
                                   : attn32::flash_fwd_f32_kernel<false>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v);
  kernel<<<attn32::grid_of(BH, S, D, attn32::kFwdWarps), 32 * attn32::kFwdWarps, smem,
           (cudaStream_t)stream>>>((const float*)q, (const float*)k, (const float*)v,
                                   (float*)o, (float*)lse, S, D, scale, vec);
  return (int)cudaGetLastError();
}

// the f32 backward kernel for head_dim D: compile-time step counts when
// D % 128 == 0, kWideWarps warps when D > 128
template <typename F>
F pick(int D, F full_narrow, F ragged_narrow, F full_wide, F ragged_wide) {
  return D > kDC ? (D % kDC == 0 ? full_wide : ragged_wide)
                 : (D % kDC == 0 ? full_narrow : ragged_narrow);
}

int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int S, int D, float scale,
            int device, void* stream) {
  using attn32::flash_bwd_dkv_f32_kernel;
  constexpr int N = attn32::kDkvWarps, W = attn32::kDkvWideWarps;
  const size_t smem = attn32::dkv_smem(D);
  const auto kernel = pick(D, flash_bwd_dkv_f32_kernel<true, N>,
                           flash_bwd_dkv_f32_kernel<false, N>,
                           flash_bwd_dkv_f32_kernel<true, W>,
                           flash_bwd_dkv_f32_kernel<false, W>);
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout);
  const int warps = attn32::dkv_warps(D);
  kernel<<<attn32::grid_of(BH, S, D, warps), 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S, D, scale, vec);
  return (int)cudaGetLastError();
}

int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dqp, int BH, int S, int D, float scale, int device,
           void* stream) {
  using attn32::flash_bwd_dq_f32_kernel;
  constexpr int N = attn32::kDqWarps, W = attn32::kDqWideWarps;
  const size_t smem = attn32::dq_smem(D);
  const auto kernel = pick(D, flash_bwd_dq_f32_kernel<true, N>,
                           flash_bwd_dq_f32_kernel<false, N>,
                           flash_bwd_dq_f32_kernel<true, W>,
                           flash_bwd_dq_f32_kernel<false, W>);
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 4 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout);
  const int warps = attn32::dq_warps(D);
  kernel<<<attn32::grid_of(BH, S, D, warps), 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dqp, S, D, scale, vec);
  return (int)cudaGetLastError();
}


// the 16-bit forward: T = tc::bf16 (the bf16 path) or tc::f16 (the f16
// draft spans)
template <typename T>
int fwd16(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S, int D,
          float scale, int device, void* stream) {
  const size_t smem = tc::fwd_smem(D);
  const auto kernel = D % kDC == 0 ? tc::flash_fwd16_kernel<T, true>
                                   : tc::flash_fwd16_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v);
  kernel<<<tc::grid_of(BH, S, D, tc::kFwdWarps), 32 * tc::kFwdWarps, smem,
           (cudaStream_t)stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, S,
                                   D, scale, vec);
  return (int)cudaGetLastError();
}

// the 16-bit backward: T = tc::bf16 or tc::f16
template <typename T>
int dkv16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, void* dk, void* dv, int BH, int S, int D, float scale,
          int device, void* stream) {
  const size_t smem = tc::dkv_smem(D);
  const auto kernel = D % kDC == 0 ? tc::flash_bwd_dkv16_kernel<T, true>
                                   : tc::flash_bwd_dkv16_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout);
  kernel<<<tc::grid_of(BH, S, D, tc::kDkvWarps), 32 * tc::kDkvWarps, smem,
           (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, S, D, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dq16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
         const void* delta, void* dqp, int BH, int S, int D, float scale, int device,
         void* stream) {
  const size_t smem = tc::dq_smem(D);
  const auto kernel = D % kDC == 0 ? tc::flash_bwd_dq16_kernel<T, true>
                                   : tc::flash_bwd_dq16_kernel<T, false>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout);
  kernel<<<tc::grid_of(BH, S, D, tc::kDqWarps), 32 * tc::kDqWarps, smem,
           (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dqp, S, D, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, o, dout,
// dk, dv, dq); lse and delta are f32 always.  Any other code
// returns cudaErrorInvalidValue and launches nothing.
// q, k, v, o: (BH, S, D) contiguous; lse: (BH, S)
int mx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int D, float scale, int dtype, int device, void* stream) {
  switch (dtype) {
    case 0: return fwd_f32(q, k, v, o, lse, BH, S, D, scale, device, stream);
    case 1: return fwd16<tc::bf16>(q, k, v, o, lse, BH, S, D, scale, device, stream);
    case 2: return fwd16<tc::f16>(q, k, v, o, lse, BH, S, D, scale, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta = rowsum(dO * O): (BH, S)
int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                     int D, float scale, int dtype, int device, void* stream) {
  switch (dtype) {
    case 0: return dkv_f32(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, device, stream);
    case 1:
      return dkv16<tc::bf16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, device, stream);
    case 2:
      return dkv16<tc::f16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dqp, int BH, int S, int D,
                    float scale, int dtype, int device, void* stream) {
  switch (dtype) {
    case 0: return dq_f32(q, k, v, dout, lse, delta, dqp, BH, S, D, scale, device, stream);
    case 1: return dq16<tc::bf16>(q, k, v, dout, lse, delta, dqp, BH, S, D, scale, device, stream);
    case 2: return dq16<tc::f16>(q, k, v, dout, lse, delta, dqp, BH, S, D, scale, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of a 16-bit kernel (bf16 or f16) at head_dim D,
// bytes: which 0 = forward, 1 = dK/dV, 2 = dQ
int mx_flash_bf16_smem(int which, int D) {
  return (int)(which == 0 ? tc::fwd_smem(D) : which == 1 ? tc::dkv_smem(D) : tc::dq_smem(D));
}

// dynamic shared memory of an f32 kernel at head_dim D, bytes (as above)
int mx_flash_f32_smem(int which, int D) {
  return (int)(which == 0   ? attn32::fwd_smem(D)
               : which == 1 ? attn32::dkv_smem(D)
                            : attn32::dq_smem(D));
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
