// The fused BatchNorm-apply, ReLU and 1x1 convolution over a 4-D
// channel-last tensor, for Hopper (sm_90a), in f32 or bf16, plain C
// interface.
//
// mx_fused_band4d replaces tools/fused_sandwich_bench.py pal4d_band (the
// Pallas kernel _kern4d), the 4-D form of mxnet_tpu/ops/fused.py
// _pallas_fwd without a residual:
//
//   Y[b, h, w, N] = relu(X[b, h, w, K] * scale[K] + shift[K]) @ W[K, N]
//
// X and W of one element type (f32 or bf16), scale and shift f32, Y
// contiguous (B, H, W, N).  W is (K, N) row-major, as the TPU kernel
// takes it (row 7's kernel, fused_matmul.cu, takes the OHWI weight as
// (N, K)).  X is read through its own four strides: a channels_last view
// of cuDNN's output and a contiguous (B, H, W, K) tensor are both taken
// as they are, with no copy on the host side.  The activation is
// computed in f32 (x * scale and + shift rounded separately, __fmul_rn
// and __fadd_rn, as the plain version computes them; NaN passes the
// ReLU as torch.relu passes it) and rounded to the element type before
// the product (the TPU kernel's z.astype(w.dtype)); the product
// accumulates in f32 and the output is rounded once.
//
// bf16 runs on the tensor cores: the mma.sync GEMM of
// fused_gemm_bf16.cuh (design and bound there; at the sandwich's shapes,
// M = 200704 and K*N = 65536, the band is bound by bytes, about 257 MB,
// 0.077 ms at 3.35 TB/s), shared with fused_matmul.cu, with W read by
// ldmatrix.trans from its (K, N) tiles.  X takes 16-byte cp.async copies
// when its channel stride is 1 and every row is 16-byte aligned, else it
// is staged element by element through its strides.  The rest of this
// file is the f32 form, on the CUDA cores.
//
// f32 design.  The TPU kernel's block is (1, th, W, K): one band of image
// rows, 28 rows of M at the sandwich's shape, which is far too few rows
// for a CUDA tile, and it keeps all of W resident (128 KB in bf16, which
// does not share an SM well).  Here M is flattened over (b, h, w) and
// tiled 128 rows at a time, whatever the image boundaries, and K is tiled
// too: a register-tiled CUDA-core GEMM (row 7's f32 form runs split TF32
// on the tensor cores, fused_gemm_f32.cuh; this one has not moved yet).
// A block computes a 128 x BN tile of Y
// (BN = 128, or 64 when N <= 64), 8 x 8 outputs per thread, over K in
// steps of 8, with double-buffered f32 shared memory.  Each thread's rows
// of X are fixed for the whole K loop, so their (b, h, w) offsets are
// computed once.  X is scaled, shifted and ReLU'd on its way from
// registers into shared memory, so the activation never exists in device
// memory.  Loads of X take four channels at once when its channel stride
// is 1 and its other strides and pointer allow; loads of W and stores of
// Y four columns at once when N % 4 == 0 and the pointers allow;
// otherwise element by element.  Every edge is checked: any B, H, W, K
// and N are taken and nothing is padded.  Each output is one thread's f32
// sum over k in order, with no split over K: two runs give the same bits.
// Block tiles walk N fastest, so the blocks sharing a tile of X rows run
// together and read it from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_gemm_bf16.cuh"

namespace {

constexpr int kBM = 128;    // rows of Y per block
constexpr int kBK = 8;      // K per step
constexpr int kPad = 4;     // floats of padding per shared-memory row

template <int BN>
struct Tile {
  static constexpr int kThreads = (kBM / 8) * (BN / 8);
  static constexpr int kTx = BN / 8;                        // threads along N
  static constexpr int kASlots = kBM * kBK / 4 / kThreads;  // 4-element slots
  static constexpr int kBSlots = BN * kBK / 4 / kThreads;
  static constexpr int kMinBlocks = BN == 128 ? 2 : 1;
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// relu(x * s + h) in f32, rounded to T (the activation enters the
// product in T)
template <typename T>
__device__ __forceinline__ float affine_relu(float x, float s, float h) {
  const float z = __fadd_rn(__fmul_rn(x, s), h);
  return to_f32<T>(from_f32<T>(z < 0.0f ? 0.0f : z));
}

// four consecutive elements of T in one aligned load or store
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ void unpack(const float4& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ float4 pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Channels col .. col + 3 of one X row at element offset `off`, widened
// to f32, zeros past K or for a row past M.  VEC: channel stride 1 and
// the four channels aligned for one load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_x4(const T* __restrict__ x, int64_t off,
                                        bool row_ok, int col, int K,
                                        int64_t sk, float (&v)[4]) {
  if (VEC) {
    if (row_ok && col < K) {
      using V = typename Vec4<T>::type;
      Vec4<T>::unpack(__ldg(reinterpret_cast<const V*>(x + off + col)), v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row_ok && col + j < K)
                 ? to_f32<T>(x[off + (int64_t)(col + j) * sk]) : 0.0f;
  }
}

// scale or shift at col .. col + 3, zeros past K
template <bool VEC>
__device__ __forceinline__ void load_k4(const float* __restrict__ p, int col,
                                        int K, float (&v)[4]) {
  if (VEC) {
    if (col < K) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + col));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < K ? p[col + j] : 0.0f;
  }
}

// W[k, n .. n + 3] of the row-major (K, N) weight, widened to f32, zeros
// past either edge
template <typename T, bool VEC>
__device__ __forceinline__ void load_w4(const T* __restrict__ w, int k, int K,
                                        int n, int N, float (&v)[4]) {
  if (VEC) {
    if (k < K && n < N) {
      using V = typename Vec4<T>::type;
      Vec4<T>::unpack(__ldg(reinterpret_cast<const V*>(w + (int64_t)k * N + n)),
                      v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (k < K && n + j < N) ? to_f32<T>(w[(int64_t)k * N + n + j]) : 0.0f;
  }
}

template <typename T, int BN, bool VEC_X, bool VEC_N>
__global__ void __launch_bounds__(Tile<BN>::kThreads, Tile<BN>::kMinBlocks)
fused_band4d_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, const T* __restrict__ w,
                    T* __restrict__ y, int64_t M, int64_t HW, int64_t Wd,
                    int64_t sb, int64_t sh, int64_t sw, int64_t sk, int K,
                    int N, int tiles_n) {
  using Tl = Tile<BN>;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % Tl::kTx, ty = tid / Tl::kTx;
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * kBM;
  const int n0 = (int)(blockIdx.x % tiles_n) * BN;

  // A slot s covers X row m0 + s / kSlots, channels k0 + (s % kSlots) * 4
  // .. + 3; B slot s covers W row k0 + s / kBRow, columns n0 + (s % kBRow)
  // * 4 .. + 3
  constexpr int kSlots = kBK / 4;
  constexpr int kBRow = BN / 4;
  int64_t xoff[Tl::kASlots];
  bool xok[Tl::kASlots];
#pragma unroll
  for (int i = 0; i < Tl::kASlots; ++i) {
    const int64_t m = m0 + (tid + i * Tl::kThreads) / kSlots;
    xok[i] = m < M;
    xoff[i] = 0;
    if (xok[i]) {
      const int64_t b = m / HW, r = m - b * HW;
      const int64_t h = r / Wd, ww = r - h * Wd;
      xoff[i] = b * sb + h * sh + ww * sw;
    }
  }
  float xa[Tl::kASlots][4], sa[Tl::kASlots][4], ha[Tl::kASlots][4];
  float wb[Tl::kBSlots][4];

  auto load_step = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tl::kASlots; ++i) {
      const int col = k0 + ((tid + i * Tl::kThreads) % kSlots) * 4;
      load_x4<T, VEC_X>(x, xoff[i], xok[i], col, K, sk, xa[i]);
      load_k4<VEC_X>(scale, col, K, sa[i]);
      load_k4<VEC_X>(shift, col, K, ha[i]);
    }
#pragma unroll
    for (int i = 0; i < Tl::kBSlots; ++i) {
      const int s = tid + i * Tl::kThreads;
      load_w4<T, VEC_N>(w, k0 + s / kBRow, K, n0 + (s % kBRow) * 4, N, wb[i]);
    }
  };
  auto store_step = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < Tl::kASlots; ++i) {
      const int s = tid + i * Tl::kThreads;
      const int r = s / kSlots, c = (s % kSlots) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        As[buf][c + j][r] = (xok[i] && k0 + c + j < K)
                                ? affine_relu<T>(xa[i][j], sa[i][j], ha[i][j])
                                : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < Tl::kBSlots; ++i) {
      const int s = tid + i * Tl::kThreads;
      *reinterpret_cast<float4*>(&Bs[buf][s / kBRow][(s % kBRow) * 4]) =
          make_float4(wb[i][0], wb[i][1], wb[i][2], wb[i][3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int steps = (K + kBK - 1) / kBK;
  if (steps > 0) {
    load_step(0);
    store_step(0, 0);
    __syncthreads();
  }
  for (int kt = 0; kt < steps; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < steps;
    if (more) load_step((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][kBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][BN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_step(cur ^ 1, (kt + 1) * kBK);
    __syncthreads();
  }

  // epilogue: thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // tx*4 + {0..3} and BN/2 + tx*4 + {0..3}
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * (BN / 2) + tx * 4;
      T* out = y + m * N + n;
      if (VEC_N) {
        if (n >= N) continue;
        const float v[4] = {acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                            acc[i][g * 4 + 3]};
        *reinterpret_cast<typename Vec4<T>::type*>(out) = Vec4<T>::pack(v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= N) break;
          out[j] = from_f32<T>(acc[i][g * 4 + j]);
        }
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <typename T, int BN>
cudaError_t launch(const T* x, const float* scale, const float* shift,
                   const T* w, T* y, int64_t M, int64_t HW, int64_t Wd,
                   int64_t sb, int64_t sh, int64_t sw, int64_t sk, int K,
                   int N, bool vx, bool vn, cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN;
  const int64_t blocks = (M + kBM - 1) / kBM * tiles_n;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(Tile<BN>::kThreads);
#define MX_LAUNCH(VX, VN)                                                     \
  fused_band4d_kernel<T, BN, VX, VN><<<grid, block, 0, stream>>>(             \
      x, scale, shift, w, y, M, HW, Wd, sb, sh, sw, sk, K, N, tiles_n)
  if (vx && vn) MX_LAUNCH(true, true);
  else if (vx) MX_LAUNCH(true, false);
  else if (vn) MX_LAUNCH(false, true);
  else MX_LAUNCH(false, false);
#undef MX_LAUNCH
  return cudaGetLastError();
}

template <typename T>
int run(const void* xv, const float* scale, const float* shift, const void* wv,
        void* yv, int64_t B, int64_t H, int64_t W, int64_t K, int64_t N,
        int64_t sb, int64_t sh, int64_t sw, int64_t sk, cudaStream_t s) {
  const T* x = (const T*)xv;
  const T* w = (const T*)wv;
  T* y = (T*)yv;
  const int vb = 4 * (int)sizeof(T);     // bytes of a four-element load
  const bool vx = sk == 1 && K % 4 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
                  sw % 4 == 0 && aligned(x, vb) && aligned(scale, 16) &&
                  aligned(shift, 16);
  const bool vn = N % 4 == 0 && aligned(w, vb) && aligned(y, vb);
  const int64_t M = B * H * W;
  if (N <= 64)
    return (int)launch<T, 64>(x, scale, shift, w, y, M, H * W, W, sb, sh, sw,
                              sk, (int)K, (int)N, vx, vn, s);
  return (int)launch<T, 128>(x, scale, shift, w, y, M, H * W, W, sb, sh, sw,
                             sk, (int)K, (int)N, vx, vn, s);
}

}  // namespace

extern "C" {

// x (B, H, W, K) at element strides (sb, sh, sw, sk), scale and shift
// (K,) f32, w (K, N) row-major, y (B, H, W, N) contiguous: x, w and y of
// one type (dtype 0 = float32, 1 = bfloat16), y overlapping none of the
// others.  Returns the CUDA error of the launch (0 when there is nothing
// to compute).
int mx_fused_band4d(const void* x, const float* scale, const float* shift,
                    const void* w, void* y, int64_t B, int64_t H, int64_t W,
                    int64_t K, int64_t N, int64_t sb, int64_t sh, int64_t sw,
                    int64_t sk, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0) return 0;
  if (K < 0 || K > INT_MAX || N > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    using fused_gemm::bf16;
    fused_gemm::Args a{(const bf16*)x, scale, shift, (const bf16*)w, nullptr, (bf16*)y,
                       B * H * W, H * W, W, sb, sh, sw, sk, (int)K, (int)N,
                       N % 8 == 0 && tc::aligned16(w), N % 8 == 0 && tc::aligned16(y), 0};
    // rows 16-byte aligned: the stride of every dimension longer than 1
    // a multiple of 8 elements
    const bool vec_x = sk == 1 && K % 8 == 0 && (B == 1 || sb % 8 == 0) &&
                       (H == 1 || sh % 8 == 0) && (W == 1 || sw % 8 == 0) &&
                       tc::aligned16(x) && tc::aligned16(scale) && tc::aligned16(shift);
    return fused_gemm::run<true>(a, vec_x, s);
  }
  return run<float>(x, scale, shift, w, y, B, H, W, K, N, sb, sh, sw, sk, s);
}

// dynamic shared memory of the bf16 kernel's tile with bn columns, bytes
int mx_fused_gemm_bf16_smem(int bn) { return fused_gemm::smem_bytes<true>(bn); }

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
