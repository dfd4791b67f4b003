// Primitive probes: four kernels that each repeat ONE unit of the seqbeam
// kernel K times on data held on chip, so that the cost of an iteration is
// the slope of the device time between two K (the launch cost cancels).
//
// Replaces the Pallas kernels of experiments/prim_bench.py:
//   minround_kernel (:35)  K rounds of packed-min selection over (rows, 128);
//   gather_kernel   (:49)  K gathers along the 8 rows of an (8, N) table;
//   matmul_kernel   (:57)  K products bf16(a + i) . b^T with f32 sums;
//   assembly_kernel (:68)  K passes of the fused elementwise score assembly.
// Each equals its plain PyTorch version (quantization_tpu_torch/experiments/
// prim_bench.py) bit for bit, except matmul, whose sums run in mma.sync
// order.
//
// Bound: operations, per iteration (the data stays on chip across the K
// iterations, so an iteration moves no bytes of device memory).  Design:
// - minround: one warp per row, four keys a lane, one __reduce_min_sync a
//   round, as K2's selection code; keys compare as unsigned integers (the
//   order of the packed non-negative floats, denormal keys included);
// - gather: one thread per column keeps its 8 rows of the table in shared
//   memory and its 8 indexes in registers; (idx + i) & 7 is the floor mod;
// - matmul: a block owns 32 rows x 64 columns and keeps its rows of a (f32)
//   and of b (bf16) in shared memory for all K; each iteration adds i to a,
//   rounds to bf16 (nearest even) and runs mma.sync m16n8k16 into a fresh
//   f32 fragment, then adds the fragment to the running sum;
// - assembly: one thread per element, col and row read once.
// All f32 arithmetic is built with --fmad=false, so each step rounds as in
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMask = 0xFFu;
constexpr int kLanes = 128;

// ---- minround

constexpr int kMinThreads = 256;  // 8 rows a block

__global__ void __launch_bounds__(kMinThreads)
minround_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kMinThreads / 32) + warp;
  if (r >= rows) return;
  const uint32_t inf_bits = __float_as_uint(1e30f);
  const float4 v = reinterpret_cast<const float4*>(x + (size_t)r * kLanes)[lane];
  const float xs[4] = {v.x, v.y, v.z, v.w};
  uint32_t key[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float f = isnan(xs[q]) ? xs[q] : fmaxf(xs[q], 0.0f);  // jnp.maximum(x, 0)
    key[q] = (__float_as_uint(f) & ~kMask) | (uint32_t)(4 * lane + q);
  }
  for (int k = 0; k < K; ++k) {
    const uint32_t m = min(min(key[0], key[1]), min(key[2], key[3]));
    const uint32_t pos = __reduce_min_sync(0xFFFFFFFFu, m) & kMask;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((uint32_t)(4 * lane + q) == pos) key[q] = inf_bits;
  }
  reinterpret_cast<float4*>(out + (size_t)r * kLanes)[lane] =
      make_float4(__uint_as_float(key[0]), __uint_as_float(key[1]), __uint_as_float(key[2]),
                  __uint_as_float(key[3]));
}

// ---- gather

constexpr int kGatherRows = 8;
constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
              float* __restrict__ out, int N, int K) {
  __shared__ float xs[kGatherRows][kGatherThreads];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kGatherThreads + t;
  const bool ok = n < N;
  uint32_t id[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) {
    xs[r][t] = ok ? x[(size_t)r * N + n] : 0.0f;
    id[r] = ok ? (uint32_t)idx[(size_t)r * N + n] : 0u;
  }
  // each thread reads only its own column of xs: no barrier
  float acc[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) acc[r] = 0.0f;
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) acc[r] = acc[r] + xs[(id[r] + (uint32_t)i) & 7u][t];
  }
  if (ok) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) out[(size_t)r * N + n] = acc[r];
  }
}

// ---- matmul

constexpr int kMmRows = 32, kMmCols = 64, kMmThreads = 128;
constexpr int kMmPad = 8;  // row padding (elements): conflict-free fragment loads

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

size_t matmul_smem(int D) {
  return (size_t)kMmRows * (D + kMmPad) * 4 + (size_t)kMmCols * (D + kMmPad) * 2;
}

// out[M, N] = sum_{i<K} bf16(a + i) . b^T; a (M, D) f32, b (N, D) bf16.
// Warp w computes rows 16 (w & 1) and columns 32 (w >> 1) of the block's tile.
__global__ void __launch_bounds__(kMmThreads)
matmul_kernel(const float* __restrict__ a, const uint16_t* __restrict__ b,
              float* __restrict__ out, int M, int N, int D, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int as = D + kMmPad;
  float* a_s = reinterpret_cast<float*>(smem);
  uint16_t* b_s = reinterpret_cast<uint16_t*>(smem + (size_t)kMmRows * as * 4);
  const int row0 = blockIdx.x * kMmRows, col0 = blockIdx.y * kMmCols;
  for (int t = threadIdx.x; t < kMmRows * D; t += kMmThreads) {
    const int r = t / D, k = t % D;
    a_s[r * as + k] = row0 + r < M ? a[(size_t)(row0 + r) * D + k] : 0.0f;
  }
  for (int t = threadIdx.x; t < kMmCols * D; t += kMmThreads) {
    const int n = t / D, k = t % D;
    b_s[n * as + k] = b[(size_t)(col0 + n) * D + k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = (warp & 1) * 16, wc = (warp >> 1) * 32;
  const float* a0 = a_s + (wr + g) * as + 2 * q;
  const float* a1 = a0 + 8 * as;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[nt][u] = 0.0f;
  for (int i = 0; i < K; ++i) {
    const float fi = (float)i;
    float prod[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) prod[nt][u] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += 16) {
      const float2 v00 = *reinterpret_cast<const float2*>(a0 + k0);
      const float2 v10 = *reinterpret_cast<const float2*>(a1 + k0);
      const float2 v01 = *reinterpret_cast<const float2*>(a0 + k0 + 8);
      const float2 v11 = *reinterpret_cast<const float2*>(a1 + k0 + 8);
      const uint32_t af[4] = {pack_bf16x2(v00.x + fi, v00.y + fi), pack_bf16x2(v10.x + fi, v10.y + fi),
                              pack_bf16x2(v01.x + fi, v01.y + fi), pack_bf16x2(v11.x + fi, v11.y + fi)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* bp = b_s + (wc + nt * 8 + g) * as + k0 + 2 * q;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(bp),
                                *reinterpret_cast<const uint32_t*>(bp + 8)};
        mma_bf16(prod[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[nt][u] = acc[nt][u] + prod[nt][u];
  }
  const int r0 = row0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + wc + nt * 8 + 2 * q;
    if (r0 < M) *reinterpret_cast<float2*>(out + (size_t)r0 * N + col) = make_float2(acc[nt][0], acc[nt][1]);
    if (r1 < M) *reinterpret_cast<float2*>(out + (size_t)r1 * N + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- assembly

constexpr int kAsmThreads = 256;

__global__ void __launch_bounds__(kAsmThreads)
assembly_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int cols, int K) {
  const long long t = (long long)blockIdx.x * kAsmThreads + threadIdx.x;
  if (t >= (long long)rows * cols) return;
  const int r = (int)(t / cols), c = (int)(t % cols);
  const float col = x[(size_t)r * cols], row = x[c];
  float acc = x[t];
  for (int k = 0; k < K; ++k) acc = ((acc - 2.0f * col) + row) + 2.0f * (acc - row);
  out[t] = acc;
}

}  // namespace

// x, out: (rows, 128) f32.
extern "C" int qtt_minround_launch(const void* x, void* out, int rows, int K, void* stream) {
  if (rows > 0) {
    const int per_block = kMinThreads / 32;
    minround_kernel<<<(rows + per_block - 1) / per_block, kMinThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, rows, K);
  }
  return (int)cudaGetLastError();
}

// x, out: (8, N) f32; idx: (8, N) int32.
extern "C" int qtt_gather_launch(const void* x, const void* idx, void* out, int N, int K,
                                 void* stream) {
  if (N > 0) {
    gather_kernel<<<(N + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                    (cudaStream_t)stream>>>((const float*)x, (const int32_t*)idx, (float*)out, N, K);
  }
  return (int)cudaGetLastError();
}

// a: (M, D) f32; b: (N, D) bf16; out: (M, N) f32.  N % 64 == 0, D % 16 == 0
// and D small enough for the shared memory are checked by the caller.
extern "C" int qtt_matmul_launch(const void* a, const void* b, void* out, int M, int N, int D,
                                 int K, void* stream) {
  if (M > 0) {
    const size_t smem = matmul_smem(D);
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((M + kMmRows - 1) / kMmRows, N / kMmCols);
    matmul_kernel<<<grid, kMmThreads, smem, (cudaStream_t)stream>>>(
        (const float*)a, (const uint16_t*)b, (float*)out, M, N, D, K);
  }
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) f32.
extern "C" int qtt_assembly_launch(const void* x, void* out, int rows, int cols, int K,
                                   void* stream) {
  const long long n = (long long)rows * cols;
  if (n > 0) {
    assembly_kernel<<<(unsigned)((n + kAsmThreads - 1) / kAsmThreads), kAsmThreads, 0,
                      (cudaStream_t)stream>>>((const float*)x, (float*)out, rows, cols, K);
  }
  return (int)cudaGetLastError();
}
