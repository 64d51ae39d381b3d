// Tensor-core building blocks for Hopper (sm_90a), shared by the bf16 and
// f16 kernels of flash_attention.cu and attention_bf16.cuh, the bf16 and
// f16 GEMM of fused_gemm_bf16.cuh and the f32 kernels of attention_f32.cuh,
// paged_attention.cu and fused_gemm_f32.cuh: cp.async copies into shared
// memory, ldmatrix fragment loads, the mma.sync m16n8k16 product with bf16
// or f16 operands and f32 sums (T16, the 16-bit element type's traits), the
// m16n8k8 product with tf32 operands and f32 sums, and split TF32 (3xTF32)
// on it; also the card's SM count that grid sizes are taken from.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 or .f16, the same
// for both): lane = 4 g + t.
// A (16 x 16, row-major) comes from ldsm_x4 over rows (lane & 15) and
// columns (lane >> 4) * 8 of the tile; B (16 x 8, k x n) from ldsm_x4 of
// an (n, k) tile or ldsm_x4_trans of a (k, n) tile, two n8 tiles per
// load; the f32 accumulator c[0], c[1] holds row g, columns 2t and
// 2t + 1, and c[2], c[3] the same columns of row g + 8.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32): A (16 x 8) a[0]
// row g, column t; a[1] row g + 8, column t; a[2], a[3] the same rows at
// column t + 4; B (8 x 8, k x n) b0 row t, b1 row t + 4, both column g;
// the accumulator as for m16n8k16.  A tf32 operand is a 32-bit register
// of which the tensor cores read the top 19 bits.  ldsm_x4 on f32 data reads four 8 x 4
// float matrices and gives lane (g, t) row g, column t of each: the A
// fragment of a row-major (16, 8) tile, or the B fragments of two n8
// tiles of an (n, k) tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;

// an H100 SXM's streaming multiprocessors, by which the launch rules of
// fused_gemm_f32.cuh and layernorm.cu size their grids
constexpr int kSMs = 132;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zeros when !ok (source size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const f16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const f16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 16, f16, row) * b (16 x 8, f16, col); the
// fragment layouts are the bf16 form's.  The sums stay f32, as the
// reference's (an f16 accumulator would run faster and round every sum)
__device__ __forceinline__ void mma_f16(float c[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 rounded to f16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 16-bit element types of the m16n8k16 products, bf16 and f16: the
// product, two f32 packed into one operand register (rounded to nearest
// even), that register's two values back as f32, one value rounded, one
// value widened to f32 (exact).
// ldmatrix and cp.async move 16-bit values of either type alike.
template <typename T> struct T16;
template <> struct T16<bf16> {
  __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    tc::mma(c, a, b0, b1);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) { return tc::pack(lo, hi); }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  __device__ __forceinline__ static bf16 round(float x) { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ static float widen(bf16 x) { return __bfloat162float(x); }
};
template <> struct T16<f16> {
  __device__ __forceinline__ static void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ __forceinline__ static f16 round(float x) { return __float2half_rn(x); }
  __device__ __forceinline__ static float widen(f16 x) { return __half2float(x); }
};

// Split TF32 ("3xTF32").  One TF32 product keeps 10 mantissa bits of each
// operand, about 2^-11 relative: too coarse for the f32 kernels'
// tolerance (rtol 1e-4 / atol 1e-5 against their plain f32 versions).
// Each operand x is split into hi = tf32(x) and lo = x - hi, and every
// product step issues three m16n8k8 products, lo * hi', hi * lo' and
// hi * hi' (mma3); the dropped lo * lo' and lo's truncation leave a few
// 2^-22 relative per product, against an f32 FMA's 2^-24.  This is the
// arithmetic of CUTLASS's OpMultiplyAddFastF32 (PyTorch's f32 SDPA
// kernel).  The tensor cores' own f32 accumulation does not round to
// nearest, so no mma chain runs long: the kernels sum a few k steps into
// a fresh fragment, then add it to their accumulator in f32.
//
// hi is x rounded to tf32, to nearest with ties away (cvt.rna's rounding,
// here by an integer add of half the 13 dropped bits' weight and a mask:
// two full-rate instructions where cvt runs on the quarter-rate
// conversion pipe); lo = x - hi is exact and passed whole, as the tensor
// cores read a tf32 operand's top 19 bits and drop the rest, so lo enters
// truncated: 2^-21 of x at most.  x is finite here.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// hi and lo of x (split) as f32 values
__device__ __forceinline__ void split_f(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = x - hi;
}

// c += a b in 3xTF32: the two cross terms, then hi * hi
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// bytes (a multiple of 16) at a 16-byte aligned global address into L2
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace tc
