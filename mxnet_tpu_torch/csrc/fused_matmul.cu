// Fused BatchNorm-apply, ReLU and 1x1 convolution for Hopper (sm_90a),
// in f32, bf16 or f16, plain C interface.
//
// mx_fused_scale_relu_matmul replaces mxnet_tpu/ops/fused.py _pallas_fwd
// (fused_scale_relu_matmul, the kernel of the _FusedBNReluConv op that
// symbol/fuse.py's pass puts at every BN -> ReLU -> Conv1x1 site of a
// channel-last ResNet):
//
//   Y[M, N] = relu(X[M, K] * scale[K] + shift[K]) @ W[N, K]^T  (+ R[M, N])
//
// X, W, R and Y of one element type (f32, bf16 or f16), scale and shift f32;
// W is the OHWI convolution weight viewed (N, K) row-major, so the
// caller passes the weight as it is stored, with no transpose copy.
// Every type runs on the tensor cores with mma.sync: bf16 and f16 through
// the two instances of the 16-bit GEMM of fused_gemm_bf16.cuh (a template
// over the element type), f32 through its split-TF32 counterpart
// fused_gemm_f32.cuh (design and bounds there), both shared with
// fused_band4d.cu.
//
// The prologue is the point: each X element is scaled, shifted and ReLU'd
// in shared memory on its way to the product, so the activation never
// exists in device memory (the unfused graph writes it once and the
// convolution reads it again).  The affine is computed in f32, the
// product x * scale and the sum + shift rounded separately (__fmul_rn,
// __fadd_rn) as the plain version computes them; NaN passes the ReLU as
// torch.relu passes it.  The product sums in f32, the residual is added
// in f32 in the epilogue and the sum is rounded once.  No split over K
// and no atomics: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_gemm_bf16.cuh"
#include "fused_gemm_f32.cuh"

namespace {

// the 16-bit GEMM in element type T, X as one image row of M pixels: row
// m at element m * K
template <typename T>
int run16(const void* x, const float* scale, const float* shift, const void* w,
          const void* res, void* y, int64_t M, int64_t K, int64_t N, cudaStream_t s) {
  fused_gemm::GemmArgs<T> a{(const T*)x, scale, shift, (const T*)w, (const T*)res,
                            (T*)y, M, M, M, 0, 0, K, 1, (int)K, (int)N,
                            K % 8 == 0 && tc::aligned16(w),
                            N % 8 == 0 && tc::aligned16(y) && (!res || tc::aligned16(res)), 0};
  const bool vec_x = K % 8 == 0 && tc::aligned16(x) && tc::aligned16(scale) &&
                     tc::aligned16(shift);
  return fused_gemm::run<T, false>(a, vec_x, s);
}

}  // namespace

extern "C" {

// x (M, K), scale and shift (K,) f32, w (N, K), res (M, N) or NULL, y
// (M, N): contiguous, x, w, res and y of one type (dtype 0 = float32,
// 1 = bfloat16, 2 = float16; any other code returns
// cudaErrorInvalidValue), y overlapping none of the others.  Returns the CUDA
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
  // one case per code: an unknown code never runs another type's kernel
  switch (dtype) {
    case 0: break;
    case 1: return run16<fused_gemm::bf16>(x, scale, shift, w, res, y, M, K, N, s);
    case 2: return run16<fused_gemm::f16>(x, scale, shift, w, res, y, M, K, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
  // X as one image row of M pixels: row m at element m * K
  fused_gemm::f32::Args a{(const float*)x, scale, shift, (const float*)w, (const float*)res,
                          (float*)y, M, M, M, 0, 0, K, 1, (int)K, (int)N,
                          K % 4 == 0 && tc::aligned16(w),
                          N % 4 == 0 && tc::aligned16(y) && (!res || tc::aligned16(res)), 0};
  const bool vec_x = K % 4 == 0 && tc::aligned16(x) && tc::aligned16(scale) &&
                     tc::aligned16(shift);
  return fused_gemm::f32::run<false>(a, vec_x, s);
}

// dynamic shared memory of the 16-bit (bf16 and f16 alike) and f32
// kernels' tiles with bn columns, bytes
int mx_fused_gemm_bf16_smem(int bn) { return fused_gemm::smem_bytes<false>(bn); }
int mx_fused_gemm_f32_smem(int bn) { return fused_gemm::f32::smem_bytes<false>(bn); }

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
