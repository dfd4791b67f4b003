// The search kernels' initial indexes: for (B, D) f32 frames x, the argmax
// over each codebook's 256 columns of the logits x . W'^T + b, where
// W' = exp(logits_scale * scale_speed) * to_logits_w (nc * 256, D) is built
// once a parameter version (ops/logits_argmax.py).  Writes (B, nc) int32
// indexes and nothing else: the (B, nc * 256) logits never reach memory.
//
// Replaces no TPU kernel: the JAX wrappers of both search kernels take the
// initial indexes from XLA's f32 matmul and argmax
// (quantization_tpu/core/search.py::compute_logits).  It replaces the port's
// chain of about 7 device ops (scale, f32 CUDA-core GEMM, bias add, argmax,
// cast), whose GEMM alone ran at 75% of the card's f32 CUDA-core peak.
//
// Arithmetic: f32-faithful products on the TF32 tensor cores.  Each operand
// is split into a TF32 high part and a TF32 remainder (round to nearest,
// ties away, as cvt.rna): a = a_hi + a_lo within 2^-22 |a|.  The three
// products lo.hi, hi.lo, hi.hi go into one f32 accumulator, in that order
// at each k-step; lo.lo (below 2^-22 of a term) is dropped.  The bias is
// added to the sum, and each row's maximum over its 256 columns is taken
// with torch.argmax's rules: the lowest index on equal values, a NaN as the
// maximum, the first NaN winning.  The weights arrive split (W_hi, W_lo);
// the kernel splits the frames.  A second kernel, logits_tables_kernel,
// builds them: scale times to_logits_w, split and laid out, in one launch
// (a trainer changes the weights every step and so builds every step).
//
// Bound: operations, 3 x 2 B D nc 256 TF32 operations at 495 TFLOP/s
// (0.26 ms at B = 8,192, D = 1,280, nc = 8).  The bytes (x once, both
// weight halves once, the indexes) are 13x below that at d1280.  What holds
// it near two thirds of the bound is shared memory: each m64n256k8 reads its
// 8 KB W tile, three products a k-step, so with the ring's writes a 16-dim
// stage moves about 170 KB through an SM's shared memory in the 1,536 cycles
// its tensor work takes, near the 128 bytes a cycle it serves.  (L2 is not
// the limit: two blocks sharing the weights by multicast ran slower on the
// H100.)
//
// Design.  A block owns one tile of 64 x WG frames and one codebook, whose
// 256 columns are wgmma's N; the codebook is the fast grid index, so the
// nc blocks of a frame tile run together and read its rows from L2.  WG
// (1 or 2) consumer warpgroups each own 64 frames and run m64n256k8 with
// both operands in shared memory, without swizzle, and nothing in registers
// but the 128 accumulators a thread: an A operand in registers leaves the
// 384-thread block (168 registers a thread) short, and the compiler then
// serializes the wgmmas.  A producer warpgroup fills a ring of four stages
// of 16 dims: one thread starts the codebook's W_hi and W_lo (16 KB each,
// laid out by the wrapper as the descriptor's core matrices) by
// cp.async.bulk on the stage's mbarrier, and each thread loads one frame
// row's 16 dims from global memory (a stage ahead), splits them and writes
// both parts as A's core matrices, one 16-byte store a (k-step, K half).
// Within each 32 dims the wrapper permutes W's dims so that logical k
// (4h + e) of k-step s is dim 8e + 2s + h: a stage's k-steps then take 4
// consecutive dims of each of 4 runs of 8, whole float4s of the frame row.
// A consumer warpgroup's row lives in one quad of one warp, so the
// epilogue's reduction is two shuffles and needs no shared memory.  The
// tile is 128 frames where B / 128 x nc blocks fill the SMs, else 64 (a
// 512-frame call at nc = 8 puts 64 blocks on the card, not 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCS = 256;                   // codewords a codebook: wgmma's N
constexpr int kLayoutDims = 32;            // dims of the wrapper's layout chunk
constexpr int kStageDims = 16;             // dims a stage: two k-steps
constexpr int kSteps = kStageDims / 8;
constexpr int kStages = 4;
constexpr int kRows = 128;                 // frame rows the A stages hold
constexpr int kStepBytes = kCS * 8 * 4;    // a k-step of W_hi or W_lo
constexpr int kWBytes = kSteps * kStepBytes;
constexpr int kAStepBytes = kRows * 8 * 4;  // a k-step of A_hi or A_lo
constexpr int kABytes = kSteps * kAStepBytes;
constexpr int kStageBytes = 2 * kWBytes + 2 * kABytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// A phase that never completes (a fault in a copy's addresses) traps after
// about 2^28 polls rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// expect `bytes` more on the phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// this thread's generic-proxy writes of shared memory made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Descriptor of a K-major operand without swizzle: core matrices of 8 rows x
// 16 bytes, `kstride` bytes between core matrices adjacent in K (the leading
// byte offset), `rstride` between 8-row groups (the stride byte offset).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t kstride, uint32_t rstride) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(kstride >> 4) << 16) |
         ((uint64_t)(rstride >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A[64 x 8] . B[256 x 8]^T in TF32 with an f32 sum, both from shared
// memory (descriptors da, db)
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(v));
  return t;
}

// v = hi + lo, each a TF32 value (the subtraction is exact)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// (v, j) before (m, i) in torch.argmax's order: a NaN first (the lower
// index among NaNs), then the larger value, then the lower index
__device__ __forceinline__ bool beats(float v, int j, float m, int i) {
  const bool v_nan = v != v, m_nan = m != m;
  if (v_nan) return !m_nan || j < i;
  return !m_nan && (v > m || (v == m && j < i));
}

__device__ __forceinline__ void quad_argmax(float& m, int& i) {
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1) {
    const float v = __shfl_xor_sync(kFull, m, s);
    const int j = __shfl_xor_sync(kFull, i, s);
    if (beats(v, j, m, i)) m = v, i = j;
  }
}

// x (B, D) f32 with D a multiple of 32; w_hi, w_lo (nc, D / 32, 4, 32, 2, 8,
// 4) f32 (ops/logits_argmax.py::weight_layout); bias (nc * 256,) f32; out
// (B, nc) int32.  Block b: codebook b % nc, frames 64 WG (b / nc) onward.
// Shared memory, a stage each: W_hi, W_lo [k-step][row group 32][K half 2]
// [row 8][4]; A_hi, A_lo [k-step][row group 16][K half 2][row 8][4].
template <int WG>
__global__ void __launch_bounds__(WG * 128 + 128, 1)
logits_argmax_kernel(const float* __restrict__ x, const float* __restrict__ w_hi,
                     const float* __restrict__ w_lo, const float* __restrict__ bias,
                     int32_t* __restrict__ out, int B, int D, int nc) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int cb = blockIdx.x % nc;
  const int row0 = (blockIdx.x / nc) * 64 * WG;
  const int stages = D / kStageDims;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);      // the producer warpgroup's threads
      mbar_init(&empty[s], 4 * WG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    // the producer warpgroup: thread t splits frame row t of the tile
    const int t = threadIdx.x - 128 * WG;
    const bool in = t < 64 * WG && row0 + t < B;
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)(row0 + t) * D);
    const size_t wcb = (size_t)cb * D * kCS;  // the codebook's W floats
    // A's core-matrix offset of row t: row group t / 8, row t % 8
    const int arow = (t / 8) * 256 + (t % 8) * 16;
    // dims 8e + 4 half + (0..3) of the layout chunk, e = 0..3: the stage's
    float4 f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = in ? __ldg(xr + 2 * e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < stages; ++q) {
      const int s = q % kStages;
      uint8_t* st = smem + s * kStageBytes;
      if (q >= kStages) mbar_wait(&empty[s], (q / kStages - 1) & 1);
      if (t == 0) {
        mbar_expect_tx(&full[s], 2 * kWBytes);
        bulk_copy(st, w_hi + wcb + (size_t)q * (kWBytes / 4), kWBytes, &full[s]);
        bulk_copy(st + kWBytes, w_lo + wcb + (size_t)q * (kWBytes / 4), kWBytes, &full[s]);
      }
      uint8_t* a_hi = st + 2 * kWBytes + arow;
      uint8_t* a_lo = a_hi + kABytes;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * k + h;  // the float4 component: dim 8e + 4 half + i
          const float v[4] = {(&f[0].x)[i], (&f[1].x)[i], (&f[2].x)[i], (&f[3].x)[i]};
          uint4 hi, lo;
          split(v[0], hi.x, lo.x);
          split(v[1], hi.y, lo.y);
          split(v[2], hi.z, lo.z);
          split(v[3], hi.w, lo.w);
          *reinterpret_cast<uint4*>(a_hi + k * kAStepBytes + h * 128) = hi;
          *reinterpret_cast<uint4*>(a_lo + k * kAStepBytes + h * 128) = lo;
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
      if (q + 1 < stages) {
        const int o = ((q + 1) / 2) * (kLayoutDims / 4) + (q + 1) % 2;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = in ? __ldg(xr + o + 2 * e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    // consumer warpgroup g owns the tile's rows 64 g .. 64 g + 63
    const int g = warp / 4;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    for (int q = 0; q < stages; ++q) {
      const int s = q % kStages;
      const uint8_t* st = smem + s * kStageBytes;
      mbar_wait(&full[s], (q / kStages) & 1);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const uint8_t* a = st + 2 * kWBytes + k * kAStepBytes + g * (kAStepBytes / 2);
        const uint64_t a_hi = wg_desc(a, 128, 256), a_lo = wg_desc(a + kABytes, 128, 256);
        const uint64_t w_h = wg_desc(st + k * kStepBytes, 128, 256);
        const uint64_t w_l = wg_desc(st + kWBytes + k * kStepBytes, 128, 256);
        wgmma_tf32(acc, a_lo, w_h);
        wgmma_tf32(acc, a_hi, w_l);
        wgmma_tf32(acc, a_hi, w_h);
      }
      wg_commit();
      wg_wait_all();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // bias, then each row's argmax: this thread holds columns 8n + 2c and
    // 8n + 2c + 1 of rows r (acc[4n], acc[4n + 1]) and r + 8 (acc[4n + 2],
    // acc[4n + 3]), in increasing order
    const int r = row0 + 64 * g + 16 * (warp % 4) + lane / 4;
    const int c = lane % 4;
    const float* b = bias + cb * kCS;
    float m0 = __int_as_float(0xff800000), m8 = m0;  // -inf
    int i0 = kCS, i8 = kCS;
#pragma unroll
    for (int n = 0; n < kCS / 8; ++n) {
      const int j = 8 * n + 2 * c;
      const float2 bj = __ldg(reinterpret_cast<const float2*>(b + j));
      const float l00 = acc[4 * n] + bj.x, l01 = acc[4 * n + 1] + bj.y;
      const float l80 = acc[4 * n + 2] + bj.x, l81 = acc[4 * n + 3] + bj.y;
      if (beats(l00, j, m0, i0)) m0 = l00, i0 = j;
      if (beats(l01, j + 1, m0, i0)) m0 = l01, i0 = j + 1;
      if (beats(l80, j, m8, i8)) m8 = l80, i8 = j;
      if (beats(l81, j + 1, m8, i8)) m8 = l81, i8 = j + 1;
    }
    quad_argmax(m0, i0);
    quad_argmax(m8, i8);
    if (c == 0) {
      if (r < B) out[(size_t)r * nc + cb] = i0;
      if (r + 8 < B) out[(size_t)(r + 8) * nc + cb] = i8;
    }
  }
}

// w (K, D) f32 times scale[0], split into TF32 parts in the layout
// logits_argmax_kernel reads (ops/logits_argmax.py::weight_layout: (K / 256,
// Dp / 32, 4, 32, 2, 8, 4), element (c, chunk, s, g, h, r, e) holding row
// 256 c + 8 g + r, dim 32 chunk + 8 e + 2 s + h), dims D to Dp zero.  A
// thread an element of the laid-out parts; the product rounds as torch's
// (no contraction), so the parts equal the plain build's bit for bit.
__global__ void logits_tables_kernel(const float* __restrict__ w, const float* __restrict__ scale,
                                     float* __restrict__ w_hi, float* __restrict__ w_lo, int K,
                                     int D, int Dp) {
  const long long n = (long long)K * Dp;
  const int chunks = Dp / kLayoutDims;
  const float sc = scale[0];
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < n;
       o += (long long)gridDim.x * blockDim.x) {
    long long t = o;
    const int e = t % 4; t /= 4;
    const int r = t % 8; t /= 8;
    const int h = t % 2; t /= 2;
    const int g = t % 32; t /= 32;
    const int s = t % 4; t /= 4;
    const int chunk = t % chunks;
    const long long row = (t / chunks) * kCS + g * 8 + r;
    const int d = chunk * kLayoutDims + e * 8 + s * 2 + h;
    const float v = d < D ? __fmul_rn(sc, w[row * D + d]) : 0.0f;
    uint32_t hi, lo;
    split(v, hi, lo);
    w_hi[o] = __uint_as_float(hi);
    w_lo[o] = __uint_as_float(lo);
  }
}

template <int WG>
int launch(const float* x, const float* w_hi, const float* w_lo, const float* bias, int32_t* out,
           int B, int D, int nc, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(logits_argmax_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + 64 * WG - 1) / (64 * WG);
  logits_argmax_kernel<WG><<<tiles * nc, WG * 128 + 128, kSmemBytes, stream>>>(
      x, w_hi, w_lo, bias, out, B, D, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D) f32, 16-byte aligned, D a multiple of 32; w_hi, w_lo the split
// weights in the kernel's layout; bias (nc * cs,) f32; out (B, nc) int32.
// cs must be 256.  The frame tile is 128 rows where ceil(B / 128) x nc
// blocks cover the card's SMs, else 64.
extern "C" int qtt_logits_argmax_launch(const void* x, const void* w_hi, const void* w_lo,
                                        const void* bias, void* out, int B, int D, int nc,
                                        int cs, void* stream) {
  if (cs != kCS || B <= 0 || nc <= 0 || D <= 0 || D % kLayoutDims)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const auto* xf = static_cast<const float*>(x);
  const auto* wh = static_cast<const float*>(w_hi);
  const auto* wl = static_cast<const float*>(w_lo);
  const auto* bf = static_cast<const float*>(bias);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if ((long long)((B + 127) / 128) * nc >= sms) return launch<2>(xf, wh, wl, bf, o, B, D, nc, st);
  return launch<1>(xf, wh, wl, bf, o, B, D, nc, st);
}

// w (K, D) f32, K a multiple of 256; scale one f32 on the card; w_hi, w_lo
// (K, Dp) f32 each, Dp the multiple of 32 at or above D, written in the
// layout qtt_logits_argmax_launch takes.
extern "C" int qtt_logits_tables_launch(const void* w, const void* scale, void* w_hi,
                                        void* w_lo, int K, int D, int Dp, void* stream) {
  if (K <= 0 || K % kCS || D <= 0 || Dp < D || Dp % kLayoutDims || Dp - D >= kLayoutDims)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)K * Dp;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  logits_tables_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<float*>(w_hi), static_cast<float*>(w_lo), K, D, Dp);
  return (int)cudaGetLastError();
}
