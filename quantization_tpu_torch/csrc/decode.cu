// Fused decode: out[b, :] = sum_n bf16(C[n, idx[b, n], :]), summed in f32 in
// codebook order.
//
// Replaces: quantization_tpu/ops/decode.py::_decode_kernel (a one-hot
// (B_t, cs) x (cs, D) bf16 MXU matmul per codebook, accumulated in f32).
// Each one-hot product has a single nonzero, so that kernel computes exactly
// "f32 sum, in codebook order, of bf16-rounded rows"; on Hopper the same
// function is a gather-sum, and this kernel equals its plain PyTorch version
// bit for bit.
//
// Bound: bytes.  The output (B * D * 4 bytes) is written once and the
// indexes (B * nc * 4 bytes) read once; the codebooks (nc * cs * D * 2
// bytes, at most 2 MB) stay in the 50 MB L2.  Design: one thread per
// (frame, 8 dims): each codebook row is one 16-byte load, the 8 f32 sums
// live in registers, and the output leaves as two 16-byte stores, so
// neighbouring threads write neighbouring addresses.  An index outside
// [0, cs) adds nothing, as the one-hot row of the TPU kernel would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__global__ void __launch_bounds__(kThreads)
decode_kernel(const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ centers,
              float* __restrict__ out, int B, int nc, int cs, int D) {
  const int chunks = D / 8;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (long long)B * chunks) return;
  const int b = (int)(gid / chunks);
  const int c = (int)(gid % chunks);
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
  for (int n = 0; n < nc; ++n) {
    const int i = idx[(size_t)b * nc + n];
    if (i < 0 || i >= cs) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        centers + ((size_t)n * cs + i) * D + (size_t)c * 8);
    acc[0] = acc[0] + bf16_lo(v.x);
    acc[1] = acc[1] + bf16_hi(v.x);
    acc[2] = acc[2] + bf16_lo(v.y);
    acc[3] = acc[3] + bf16_hi(v.y);
    acc[4] = acc[4] + bf16_lo(v.z);
    acc[5] = acc[5] + bf16_hi(v.z);
    acc[6] = acc[6] + bf16_lo(v.w);
    acc[7] = acc[7] + bf16_hi(v.w);
  }
  float4* o = reinterpret_cast<float4*>(out + (size_t)b * D + (size_t)c * 8);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace

// idx: (B, nc) int32; centers: (nc * cs, D) bf16; out: (B, D) f32.
// D % 8 == 0 and 16-byte aligned rows are checked by the caller.
extern "C" int qtt_decode_launch(const void* idx, const void* centers, void* out,
                                 int B, int nc, int cs, int D, void* stream) {
  const long long threads = (long long)B * (D / 8);
  if (threads > 0) {
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    decode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const __nv_bfloat16*)centers, (float*)out, B, nc, cs, D);
  }
  return (int)cudaGetLastError();
}
