// Fused BatchNorm-apply, ReLU and 1x1 convolution for Hopper (sm_90a),
// in f32 or bf16, plain C interface.
//
// mx_fused_scale_relu_matmul replaces mxnet_tpu/ops/fused.py _pallas_fwd
// (fused_scale_relu_matmul, the kernel of the _FusedBNReluConv op that
// symbol/fuse.py's pass puts at every BN -> ReLU -> Conv1x1 site of a
// channel-last ResNet):
//
//   Y[M, N] = relu(X[M, K] * scale[K] + shift[K]) @ W[N, K]^T  (+ R[M, N])
//
// X, W, R and Y of one element type (f32 or bf16), scale and shift f32;
// W is the OHWI convolution weight viewed (N, K) row-major, so the
// caller passes the weight as it is stored, with no transpose copy.
//
// bf16 runs on the tensor cores: the mma.sync GEMM of
// fused_gemm_bf16.cuh (design and bound there), shared with
// fused_band4d.cu, with X as a contiguous (M, K) matrix and W (N, K).
// The rest of this file is the f32 form, on the CUDA cores (f32 parity
// at rtol 2e-5 rules out TF32).
//
// The prologue is the point: each X element is scaled, shifted and ReLU'd
// on its way from the register file into shared memory, so the activation
// never exists in device memory (the unfused graph writes it once and the
// convolution reads it again).  The affine and the ReLU are computed in
// f32; the product accumulates in f32, the residual is added in f32 in
// the epilogue and the sum is rounded once.  The product x * scale and
// the sum + shift are rounded separately (__fmul_rn, __fadd_rn), as the
// plain version computes them, so the kernel's activation is the plain
// version's bit for bit; NaN passes the ReLU as torch.relu passes it.
//
// What bounds the f32 form on the H100: 2*M*N*K operations on the CUDA
// cores (67 TFLOP/s) against 4 * (M*K + N*K + M*N (+ M*N)) bytes: the
// stage-1 sites of ResNet-50 are bound by bytes and the others by
// operations.
//
// f32 design.  The TPU kernel keeps all of W resident in VMEM and walks row
// tiles of X; W reaches 4 MB here (2048 x 512), far over the 227 KB of
// shared memory a block may use, so K is tiled too: a register-tiled
// CUDA-core GEMM.  A block computes a 128 x BN tile of Y (BN = 128, or 64
// when N <= 64 so a narrow output wastes no work), 8 x 8 outputs per
// thread (256 threads, two blocks per SM, or 128), over K in steps of 8.
// Shared memory is double-buffered, in f32: while the block multiplies
// step k out of one buffer, each thread holds step k + 1's loads in
// registers and writes them, with the prologue applied, into the other
// buffer; one barrier per step.  The
// tiles are stored k-major (As[k][m], Bs[k][n]) with 4 floats of padding
// per row, so both the transposing stores and the 16-byte fragment loads
// of the inner product are free of bank conflicts.  Loads take four
// elements at once when K % 4 == 0 and the operands are aligned to 16
// bytes, the epilogue likewise when N % 4 == 0; otherwise every element
// is loaded or stored on its own.  Every edge is checked: any M, K and N
// are taken, nothing is padded, and out-of-range elements enter the
// tiles as zeros after the prologue.  f32 FMA throughout (no TF32), and
// each output is one thread's sum over k in order, with no split over K:
// two runs give the same bits.  Block tiles walk N fastest, so the blocks
// sharing an X row tile run together and read it from L2.
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
  static constexpr int kTx = BN / 8;                      // threads along N
  static constexpr int kALoads = kBM * kBK / 4 / kThreads;  // 4-float slots
  static constexpr int kBLoads = BN * kBK / 4 / kThreads;
  // two 256-thread blocks per SM: the register cap (128) that buys the
  // second block hides more latency than the few registers cost
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

// four consecutive elements of T in one aligned load
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

// Four consecutive elements of row `row` (< rows) at column `col` of a
// row-major (rows, K) matrix, widened to f32, zeros past either edge.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int64_t row,
                                      int64_t rows, int col, int K,
                                      float (&v)[4]) {
  if (VEC) {
    if (row < rows && col < K) {
      using V = typename Vec4<T>::type;
      Vec4<T>::unpack(__ldg(reinterpret_cast<const V*>(p + row * K + col)), v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (row < rows && col + j < K) ? to_f32<T>(p[row * K + col + j]) : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_vec4(const float* __restrict__ p, int col,
                                          int K, float (&v)[4]) {
  load4<float, VEC>(p, 0, 1, col, K, v);
}

template <typename T, int BN, bool VEC_K, bool VEC_N>
__global__ void __launch_bounds__(Tile<BN>::kThreads, Tile<BN>::kMinBlocks)
fused_scale_relu_matmul_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift,
                               const T* __restrict__ w,
                               const T* __restrict__ res,
                               T* __restrict__ y, int64_t M, int K, int N,
                               int tiles_n) {
  using Tl = Tile<BN>;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % Tl::kTx, ty = tid / Tl::kTx;
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * kBM;
  const int n0 = (int)(blockIdx.x % tiles_n) * BN;

  // A slot s covers X[m0 + s / kSlots, k0 + (s % kSlots) * 4 .. + 3];
  // B slot s covers W[n0 + s / kSlots, k0 + (s % kSlots) * 4 .. + 3]
  constexpr int kSlots = kBK / 4;
  float xa[Tl::kALoads][4], sa[Tl::kALoads][4], ha[Tl::kALoads][4];
  float wb[Tl::kBLoads][4];

  auto load_step = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tl::kALoads; ++i) {
      const int s = tid + i * Tl::kThreads;
      const int col = k0 + (s % kSlots) * 4;
      load4<T, VEC_K>(x, m0 + s / kSlots, M, col, K, xa[i]);
      load_vec4<VEC_K>(scale, col, K, sa[i]);
      load_vec4<VEC_K>(shift, col, K, ha[i]);
    }
#pragma unroll
    for (int i = 0; i < Tl::kBLoads; ++i) {
      const int s = tid + i * Tl::kThreads;
      load4<T, VEC_K>(w, n0 + s / kSlots, N, k0 + (s % kSlots) * 4, K, wb[i]);
    }
  };
  auto store_step = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < Tl::kALoads; ++i) {
      const int s = tid + i * Tl::kThreads;
      const int r = s / kSlots, c = (s % kSlots) * 4;
      const bool row_ok = m0 + r < M;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        As[buf][c + j][r] = (row_ok && k0 + c + j < K)
                                ? affine_relu<T>(xa[i][j], sa[i][j], ha[i][j])
                                : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < Tl::kBLoads; ++i) {
      const int s = tid + i * Tl::kThreads;
      const int r = s / kSlots, c = (s % kSlots) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[buf][c + j][r] = wb[i][j];
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
      const T* rp = res ? res + m * N + n : nullptr;
      if (VEC_N) {
        if (n >= N) continue;
        using V = typename Vec4<T>::type;
        float v[4] = {acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                      acc[i][g * 4 + 3]};
        if (rp) {
          float r[4];
          Vec4<T>::unpack(__ldg(reinterpret_cast<const V*>(rp)), r);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += r[j];
        }
        *reinterpret_cast<V*>(out) = Vec4<T>::pack(v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= N) break;
          out[j] = from_f32<T>(rp ? acc[i][g * 4 + j] + to_f32<T>(rp[j])
                                  : acc[i][g * 4 + j]);
        }
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <typename T, int BN>
cudaError_t launch(const T* x, const float* scale, const float* shift,
                   const T* w, const T* res, T* y, int64_t M,
                   int K, int N, bool vk, bool vn, cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN;
  const int64_t blocks = (M + kBM - 1) / kBM * tiles_n;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(Tile<BN>::kThreads);
#define MX_LAUNCH(VK, VN)                                                     \
  fused_scale_relu_matmul_kernel<T, BN, VK, VN><<<grid, block, 0, stream>>>( \
      x, scale, shift, w, res, y, M, K, N, tiles_n)
  if (vk && vn) MX_LAUNCH(true, true);
  else if (vk) MX_LAUNCH(true, false);
  else if (vn) MX_LAUNCH(false, true);
  else MX_LAUNCH(false, false);
#undef MX_LAUNCH
  return cudaGetLastError();
}

template <typename T>
int run(const void* xv, const float* scale, const float* shift, const void* wv,
        const void* rv, void* yv, int64_t M, int64_t K, int64_t N, cudaStream_t s) {
  const T* x = (const T*)xv;
  const T* w = (const T*)wv;
  const T* res = (const T*)rv;
  T* y = (T*)yv;
  const int vb = 4 * (int)sizeof(T);     // bytes of a four-element load
  const bool vk = K % 4 == 0 && aligned(x, vb) && aligned(scale, 16) &&
                  aligned(shift, 16) && aligned(w, vb);
  const bool vn = N % 4 == 0 && aligned(y, vb) && (!res || aligned(res, vb));
  if (N <= 64)
    return (int)launch<T, 64>(x, scale, shift, w, res, y, M, (int)K, (int)N, vk, vn, s);
  return (int)launch<T, 128>(x, scale, shift, w, res, y, M, (int)K, (int)N, vk, vn, s);
}

}  // namespace

extern "C" {

// x (M, K), scale and shift (K,) f32, w (N, K), res (M, N) or NULL, y
// (M, N): contiguous, x, w, res and y of one type (dtype 0 = float32,
// 1 = bfloat16), y overlapping none of the others.  Returns the CUDA
// error of the launch (0 when M or N is 0: nothing to compute).
int mx_fused_scale_relu_matmul(const void* x, const float* scale,
                               const float* shift, const void* w,
                               const void* res, void* y, int64_t M,
                               int64_t K, int64_t N, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || K > INT_MAX || N > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    // X as one image row of M pixels: row m at element m * K
    using fused_gemm::bf16;
    fused_gemm::Args a{(const bf16*)x, scale, shift, (const bf16*)w, (const bf16*)res,
                       (bf16*)y, M, M, M, 0, 0, K, 1, (int)K, (int)N,
                       K % 8 == 0 && tc::aligned16(w),
                       N % 8 == 0 && tc::aligned16(y) && (!res || tc::aligned16(res)), 0};
    const bool vec_x = K % 8 == 0 && tc::aligned16(x) && tc::aligned16(scale) &&
                       tc::aligned16(shift);
    return fused_gemm::run<false>(a, vec_x, s);
  }
  return run<float>(x, scale, shift, w, res, y, M, K, N, s);
}

// dynamic shared memory of the bf16 kernel's tile with bn columns, bytes
int mx_fused_gemm_bf16_smem(int bn) { return fused_gemm::smem_bytes<false>(bn); }

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
