// Error-feedback 2-bit quantize for Hopper (sm_90a), plain C interface.
//
// mx_two_bit_quantize replaces mxnet_tpu/pallas/quant.py
// two_bit_quantize_fused (_two_bit_quantize_kernel), the quantizer of the
// kvstore's 2-bit gradient compression (kvstore_fused.two_bit_quantize):
//
//   acc = r + g;  q = acc > t ? t : (acc < -t ? -t : 0);  new_r = acc - q
//
// over n f32 elements, with the threshold t an f32 value rounded on the
// host.  Every operation is spelled out so the result is the JAX
// package's bit for bit: one f32 add, two compares against the f32
// threshold, selects of exact constants, one f32 subtract (no product, so
// no contraction can change a bit; the build has no fast-math flag).  NaN
// compares false both ways, so it gives q = 0 and a NaN residual; -0.0
// survives (-0.0 - +0.0 is -0.0); +-inf gives q = +-t and a +-inf
// residual.
//
// What bounds it on the H100: 16 bytes per element (read r and g, write q
// and new_r) against one add, two compares and one subtract, so bytes:
// n * 16 / 3.35 TB/s, 5 us for a 4 MiB bucket of 1,048,576 elements.
//
// Design: the TPU kernel tiled the flattened operands into (64, 128) VMEM
// blocks and padded the tail to a whole tile; here nothing is padded and
// nothing is written past n.  One grid-stride pass; when the four
// pointers share their offset modulo 16 bytes, a short scalar head brings
// them to a 16-byte boundary, the body moves float4 vectors (one 16-byte
// load or store per operand per thread per step, neighbouring threads on
// neighbouring addresses) and a scalar tail finishes; otherwise the whole
// pass is scalar.  The outputs are separate buffers: the residual is not
// overwritten in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;      // 8 blocks per SM fill the card

__device__ __forceinline__ void quantize_one(float r, float g, float t,
                                             float* q, float* nr) {
  const float acc = r + g;
  const float v = acc > t ? t : (acc < -t ? -t : 0.0f);
  *q = v;
  *nr = acc - v;
}

__global__ void two_bit_quantize_kernel(const float* __restrict__ r,
                                        const float* __restrict__ g,
                                        float* __restrict__ q,
                                        float* __restrict__ nr, int64_t n,
                                        int64_t head, int64_t nvec,
                                        float t) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // scalar head: the elements before the first shared 16-byte boundary
  for (int64_t i = tid; i < head; i += stride)
    quantize_one(r[i], g[i], t, q + i, nr + i);
  // vector body
  const float4* r4 = reinterpret_cast<const float4*>(r + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* q4 = reinterpret_cast<float4*>(q + head);
  float4* nr4 = reinterpret_cast<float4*>(nr + head);
  for (int64_t i = tid; i < nvec; i += stride) {
    const float4 a = r4[i];
    const float4 b = g4[i];
    float4 vq, vr;
    quantize_one(a.x, b.x, t, &vq.x, &vr.x);
    quantize_one(a.y, b.y, t, &vq.y, &vr.y);
    quantize_one(a.z, b.z, t, &vq.z, &vr.z);
    quantize_one(a.w, b.w, t, &vq.w, &vr.w);
    q4[i] = vq;
    nr4[i] = vr;
  }
  // scalar tail (or the whole pass when nvec == 0)
  for (int64_t i = head + 4 * nvec + tid; i < n; i += stride)
    quantize_one(r[i], g[i], t, q + i, nr + i);
}

}  // namespace

extern "C" {

// r, g: the residual and gradient; q, nr: the quantized gradient and the
// new residual; all n f32 elements, no two overlapping.
int mx_two_bit_quantize(const float* r, const float* g, float* q, float* nr,
                        int64_t n, float threshold, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const uintptr_t off = (uintptr_t)r & 15;
  const bool same = ((uintptr_t)g & 15) == off && ((uintptr_t)q & 15) == off
                    && ((uintptr_t)nr & 15) == off && (off & 3) == 0;
  int64_t head = 0, nvec = 0;
  if (same) {
    head = (int64_t)(((16 - off) & 15) / 4);
    if (head > n) head = n;
    nvec = (n - head) / 4;
  }
  const int64_t work = nvec > 0 ? nvec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  two_bit_quantize_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(r, g, q, nr, n, head,
                                                     nvec, threshold);
  return (int)cudaGetLastError();
}

const char* mx_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
