// The fused BatchNorm-apply, ReLU and 1x1 convolution over a 4-D
// channel-last tensor, for Hopper (sm_90a), in f32, bf16 or f16, plain C
// interface.
//
// mx_fused_band4d replaces tools/fused_sandwich_bench.py pal4d_band (the
// Pallas kernel _kern4d), the 4-D form of mxnet_tpu/ops/fused.py
// _pallas_fwd without a residual:
//
//   Y[b, h, w, N] = relu(X[b, h, w, K] * scale[K] + shift[K]) @ W[K, N]
//
// X and W of one element type (f32, bf16 or f16), scale and shift f32, Y
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
// Every type runs on the tensor cores through the GEMMs row 7 runs, so
// rows 7 and 10 give the same bits on the same operands.  bf16 and f16:
// the two instances of the mma.sync GEMM of fused_gemm_bf16.cuh (a
// template over the 16-bit type), W read by ldmatrix.trans from its
// (K, N) tiles (at the sandwich's shapes, M = 200704 and K*N = 65536, the
// band is bound by bytes, about 257 MB, 0.077 ms at 3.35 TB/s).  f32: the
// split-TF32 GEMM of fused_gemm_f32.cuh with W (K, N) (design, the two
// ways of loading W and the bound there; each band takes 2.63e10
// operations, 0.161 ms at 494.7 / 3 TFLOP/s).  The TPU kernel's block is
// (1, th, W, K), one band of image rows with all of W resident; here M is
// flattened over (b, h, w) and tiled 128 rows at a time, whatever the
// image boundaries, each row's offset worked out from its (b, h, w) once
// per block.  X takes 16-byte cp.async copies when its channel stride is
// 1 and every row is 16-byte aligned, else it is staged element by
// element through its strides; W and Y take 16-byte copies when N and
// their pointers allow.  Any B, H, W, K and N; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_gemm_bf16.cuh"
#include "fused_gemm_f32.cuh"

extern "C" {

// x (B, H, W, K) at element strides (sb, sh, sw, sk), scale and shift
// (K,) f32, w (K, N) row-major, y (B, H, W, N) contiguous: x, w and y of
// one type (dtype 0 = float32, 1 = bfloat16, 2 = float16; any other code
// returns cudaErrorInvalidValue), y overlapping none of the others.
// Returns the CUDA error of the launch (0 when there is nothing to
// compute).
int mx_fused_band4d(const void* x, const float* scale, const float* shift,
                    const void* w, void* y, int64_t B, int64_t H, int64_t W,
                    int64_t K, int64_t N, int64_t sb, int64_t sh, int64_t sw,
                    int64_t sk, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0) return 0;
  if (K < 0 || K > INT_MAX || N > INT_MAX) return (int)cudaErrorInvalidValue;
  // one case per code: an unknown code never runs another type's kernel
  if (dtype != 0 && dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte copies of X: channel stride 1, K a multiple of the vector and
  // every row 16-byte aligned (the stride of every dimension longer than
  // 1 a multiple of the vector); 8 elements of either 16-bit type
  const int64_t v = dtype == 0 ? 4 : 8;
  const bool vec_x = sk == 1 && K % v == 0 && (B == 1 || sb % v == 0) &&
                     (H == 1 || sh % v == 0) && (W == 1 || sw % v == 0) &&
                     tc::aligned16(x) && tc::aligned16(scale) && tc::aligned16(shift);
  const int vec_w = N % v == 0 && tc::aligned16(w), vec_y = N % v == 0 && tc::aligned16(y);
  if (dtype == 1) {
    using fused_gemm::bf16;
    fused_gemm::GemmArgs<bf16> a{(const bf16*)x, scale, shift, (const bf16*)w, nullptr,
                                 (bf16*)y, B * H * W, H * W, W, sb, sh, sw, sk, (int)K,
                                 (int)N, vec_w, vec_y, 0};
    return fused_gemm::run<bf16, true>(a, vec_x, s);
  }
  if (dtype == 2) {
    using fused_gemm::f16;
    fused_gemm::GemmArgs<f16> a{(const f16*)x, scale, shift, (const f16*)w, nullptr,
                                (f16*)y, B * H * W, H * W, W, sb, sh, sw, sk, (int)K,
                                (int)N, vec_w, vec_y, 0};
    return fused_gemm::run<f16, true>(a, vec_x, s);
  }
  fused_gemm::f32::Args a{(const float*)x, scale, shift, (const float*)w, nullptr, (float*)y,
                          B * H * W, H * W, W, sb, sh, sw, sk, (int)K, (int)N,
                          vec_w, vec_y, 0};
  return fused_gemm::f32::run<true>(a, vec_x, s);
}

// dynamic shared memory of the 16-bit (bf16 and f16 alike) and f32
// kernels' tiles with bn columns, bytes
int mx_fused_gemm_bf16_smem(int bn) { return fused_gemm::smem_bytes<true>(bn); }
int mx_fused_gemm_f32_smem(int bn) { return fused_gemm::f32::smem_bytes<true>(bn); }

const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
