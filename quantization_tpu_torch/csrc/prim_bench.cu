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
// prim_bench.py) bit for bit, except matmul, whose sums run in wgmma's order.
//
// Bound: operations, per iteration (the data stays on chip across the K
// iterations, so an iteration moves no bytes of device memory).  Design:
// - minround: one warp per row, four keys a lane, keys compared as unsigned
//   integers (the order of the packed non-negative floats, denormal keys
//   included).  A round is one dependent chain a row, so its floor is the
//   latency of one warp-wide reduction (redux_chain_kernel measures it).
//   As K2's selection (csrc/seqbeam.cu, sort8 and pop_min): each lane sorts
//   its own 4 keys once, then a round is __reduce_min_sync over the lanes'
//   least keys, one compare and one select; the winning lane shifts its
//   sorted keys off the chain (each capped at 1e30 once, so that the select
//   on the chain is a plain one).  A taken key counts as 1e30 in later rounds,
//   as in the JAX kernel, where it stays in the row;
// - gather: one thread per column keeps its 8 rows of the table in shared
//   memory, 1 KB apart, and its 8 indexes in registers, scaled to bytes (idx
//   << 10).  Each gather is one add and one mask, ((idx + i) << 10) & 0x1C00
//   (the floor mod 8 of idx + i, as a row's byte offset), one shared load
//   and one add: the shared-memory pipe (32 loads a clock an SM) is the
//   floor (gather_floor_kernel measures it: the same loads from fixed rows,
//   with no index math), and the loop, unrolled by 4, keeps the next loads
//   in flight;
// - matmul: 2 M N D bf16 operations an iteration on the tensor cores, plus
//   the conversions of a + i.  Reading the operands from shared memory every
//   iteration, as the first port did, cost more than the products (measured
//   by stage, PERF.md), so nothing is read in the loop: 4 blocks of 2
//   warpgroups share a tile of 64 rows x 128 columns, each warpgroup a slice
//   of 64 dimensions, its a in registers (wgmma's A, rounded to bf16 each
//   iteration) and its b in shared memory (wgmma's B), loaded once; 128
//   blocks, one an SM; the two warpgroups of an SM take turns on the tensor
//   cores, each converting its next A while its products run; the tile's
//   sums meet once at the end;
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
constexpr uint32_t kInfBits = 0x7149F2CAu;  // 1e30f, a taken key; its low byte names no lane
constexpr uint32_t kNone = 0xFFFFFFFFu;    // above every key

// The row's keys as the JAX kernel packs them: max(x, 0)'s bits with the
// low byte replaced by the key's position, 4 lane + q.
__device__ __forceinline__ void row_keys(const float* __restrict__ x, int r, int lane,
                                         uint32_t (&key)[4]) {
  const float4 v = reinterpret_cast<const float4*>(x + (size_t)r * kLanes)[lane];
  const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float f = isnan(xs[q]) ? xs[q] : fmaxf(xs[q], 0.0f);  // jnp.maximum(x, 0)
    key[q] = (__float_as_uint(f) & ~kMask) | (uint32_t)(4 * lane + q);
  }
}

// A lane's 4 keys ascending (a 5-comparator network).
__device__ __forceinline__ void sort4(uint32_t (&k)[4]) {
  constexpr int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const uint32_t lo = min(k[net[c][0]], k[net[c][1]]), hi = max(k[net[c][0]], k[net[c][1]]);
    k[net[c][0]] = lo;
    k[net[c][1]] = hi;
  }
}

// Each round takes the row's least key w; its position w & 0xFF becomes
// 1e30.  A lane holds `head`, its least key counting each taken key as
// 1e30 (s[0] before its first take, then min(untaken, 1e30)), and behind
// it its other untaken keys in order, each capped at 1e30 (u1 <= u2 <=
// u3).  A round: w = the warp's least head; the lane whose head is w moves
// u1 into head (one select), and if w is 1e30 nothing is taken (0xCA names
// no lane), which leaves every head as it is.  Off the chain, the taking
// lane shifts u and keeps w in `last`: a lane's taken keys are its keys up
// to `last`, the largest it took.
__global__ void __launch_bounds__(kMinThreads)
minround_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kMinThreads / 32) + warp;
  if (r >= rows) return;
  uint32_t key[4];
  row_keys(x, r, lane, key);
  uint32_t s[4] = {key[0], key[1], key[2], key[3]};
  sort4(s);
  uint32_t head = s[0], last = kNone;  // kNone: nothing taken
  uint32_t u1 = min(s[1], kInfBits), u2 = min(s[2], kInfBits), u3 = min(s[3], kInfBits);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const bool real = head != kInfBits;  // the lane's own: w is 1e30 only where head is
    const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, head);
    const bool mine = head == w;
    const bool take = mine && real;
    head = mine ? u1 : head;
    u1 = take ? u2 : u1;
    u2 = take ? u3 : u2;
    u3 = take ? kInfBits : u3;
    last = take ? w : last;
  }
  const bool any = last != kNone;
  reinterpret_cast<float4*>(out + (size_t)r * kLanes)[lane] = make_float4(
      __uint_as_float(any && key[0] <= last ? kInfBits : key[0]),
      __uint_as_float(any && key[1] <= last ? kInfBits : key[1]),
      __uint_as_float(any && key[2] <= last ? kInfBits : key[2]),
      __uint_as_float(any && key[3] <= last ? kInfBits : key[3]));
}

// The floor of a round: each row's warp takes its least key once, then runs
// K dependent warp-wide reductions of it and nothing else; out[r] is the
// row's least key.  Same grid as minround_kernel.
__global__ void __launch_bounds__(kMinThreads)
redux_chain_kernel(const float* __restrict__ x, uint32_t* __restrict__ out, int rows, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kMinThreads / 32) + warp;
  if (r >= rows) return;
  uint32_t key[4];
  row_keys(x, r, lane, key);
  uint32_t m = __reduce_min_sync(0xFFFFFFFFu, min(min(key[0], key[1]), min(key[2], key[3])));
  for (int k = 0; k < K; ++k)
    asm volatile("redux.sync.min.u32 %0, %0, 0xffffffff;" : "+r"(m));
  if (lane == 0) out[r] = m;
}

// ---- gather

constexpr int kGatherRows = 8;
constexpr int kGatherThreads = 256;  // a row of the block's table: 1 KB
constexpr int kGatherUnroll = 4;

// The table's element at byte offset `row_bytes` (a row's offset, 0 to 7 KB)
// of thread t's column (t4 = 4 t).
__device__ __forceinline__ float table_at(const float* xs, uint32_t row_bytes, uint32_t t4) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(xs) + (row_bytes | t4));
}

// Thread t's column n of the table into shared memory (row r at byte
// r << 10 of xs) and its 8 indexes, scaled to bytes (idx << 10).  Each
// thread reads only its own column of xs: no barrier.
__device__ __forceinline__ void gather_column(const float* __restrict__ x,
                                              const int32_t* __restrict__ idx, int N, int n,
                                              bool ok, float* xs, uint32_t (&id)[kGatherRows]) {
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) {
    xs[r * kGatherThreads + threadIdx.x] = ok ? x[(size_t)r * N + n] : 0.0f;
    id[r] = (ok ? (uint32_t)idx[(size_t)r * N + n] : 0u) << 10;
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
              float* __restrict__ out, int N, int K) {
  __shared__ float xs[kGatherRows * kGatherThreads];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kGatherThreads + t;
  const bool ok = n < N;
  const uint32_t t4 = 4u * (uint32_t)t;
  uint32_t id[kGatherRows];  // (idx + i) << 10: its bits 10-12 are (idx + i) mod 8
  gather_column(x, idx, N, n, ok, xs, id);
  float acc[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) acc[r] = 0.0f;
  // id[r] = (idx + i) << 10 at iteration i: one add and one mask a gather.
  // Unrolled by hand: the compiler's own unroll of the one loop (#pragma
  // unroll 4) schedules it 11% slower (measured in turns, PERF.md)
  int i = 0;
  for (; i + kGatherUnroll <= K; i += kGatherUnroll) {
#pragma unroll
    for (int j = 0; j < kGatherUnroll; ++j) {
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        acc[r] = acc[r] + table_at(xs, id[r] & 0x1C00u, t4);
        id[r] += 1u << 10;
      }
    }
  }
  for (; i < K; ++i) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) {
      acc[r] = acc[r] + table_at(xs, id[r] & 0x1C00u, t4);
      id[r] += 1u << 10;
    }
  }
  if (ok) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) out[(size_t)r * N + n] = acc[r];
  }
}

// The floor of a gather: gather_kernel's table and loop with each row's
// index fixed at idx mod 8, formed once, so that an iteration is 8 shared
// loads (volatile, so that none leaves the loop) and 8 adds and nothing
// else; out[r, n] = sum_{i<K} x[idx[r, n] mod 8, n], summed in order.
__global__ void __launch_bounds__(kGatherThreads)
gather_floor_kernel(const float* __restrict__ x, const int32_t* __restrict__ idx,
                    float* __restrict__ out, int N, int K) {
  __shared__ float xs[kGatherRows * kGatherThreads];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kGatherThreads + t;
  const bool ok = n < N;
  uint32_t id[kGatherRows];
  gather_column(x, idx, N, n, ok, xs, id);
  const volatile float* at[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r)
    at[r] = reinterpret_cast<const volatile float*>(reinterpret_cast<const char*>(xs) +
                                                    ((id[r] & 0x1C00u) | 4u * (uint32_t)t));
  float acc[kGatherRows];
#pragma unroll
  for (int r = 0; r < kGatherRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) acc[r] = acc[r] + *at[r];
  }
  if (ok) {
#pragma unroll
    for (int r = 0; r < kGatherRows; ++r) out[(size_t)r * N + n] = acc[r];
  }
}

// ---- matmul

// stages of the timed build (experiments/prim_bench.py::MATMUL_STAGES)
enum { kStLoad, kStConvert, kStMma, kStAcc, kStEpilogue, kStages };

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t clock_now() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(t)::"memory");
  return t;
}

// Per-warp clock cycles of each stage, in 32 bits (registers are what the
// kernel lacks); ON = false compiles to nothing.  lap(s) charges the cycles
// since the last lap to stage s.  An instruction's wait for its operands
// falls in the stage that uses them.
template <bool ON>
struct StageClock {
  uint32_t acc[kStages];
  uint32_t last;
  long long ns0;
  __device__ __forceinline__ void start() {
    if constexpr (ON) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) acc[s] = 0;
      ns0 = global_ns();
      last = clock_now();
    }
  }
  __device__ __forceinline__ void lap(int s) {
    if constexpr (ON) {
      const uint32_t now = clock_now();
      acc[s] += now - last;
      last = now;
    }
  }
  // lane 0 of each warp adds its sums to the block's row of `stages`; the
  // longest warp's own cycles (its stages' sum: every cycle from the start
  // to the last lap is some stage's) and nanoseconds stand for the block's
  __device__ __forceinline__ void finish(long long* stages, int lane) {
    if constexpr (ON) {
      if (lane == 0) {
        const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
        unsigned long long* r =
            reinterpret_cast<unsigned long long*>(stages + (size_t)blk * (kStages + 2));
        unsigned long long total = 0;
#pragma unroll
        for (int s = 0; s < kStages; ++s) {
          atomicAdd(r + s, (unsigned long long)acc[s]);
          total += acc[s];
        }
        atomicMax(r + kStages, total);
        atomicMax(r + kStages + 1, (unsigned long long)(global_ns() - ns0));
      }
    }
  }
};

// 4 blocks (blockIdx.x = 0 .. 3) own a tile of 64 rows x 128 columns of out
// and split the dimensions 8 ways: warpgroup h of block x takes the slice s =
// 2 x + h, dimensions [16 KS s, 16 KS (s + 1)) (KS k-steps of 16, D <= 128 KS).
constexpr int kMmRows = 64, kMmCols = 128, kMmSplit = 4, kMmGroups = 2;
constexpr int kMmThreads = 128 * kMmGroups;
constexpr int kMmSlices = kMmSplit * kMmGroups;
constexpr int kMmTile = kMmRows * kMmCols;          // floats of a block's sums
constexpr int kMmChain = 4;                         // iterations a product's sum runs in C
constexpr int kMmMaxKs = 4;                         // D <= 512
constexpr int kMmChunk = kMmCols * 16;              // bytes of b's 8 dimensions (a core-matrix column)
constexpr int kMmBBytes = 2 * kMmMaxKs * kMmChunk;  // a warpgroup's slice of b
constexpr int kMmRedStride = kMmCols + 8;           // floats a row of the block's sums (padded)
constexpr size_t kMmSmem = (size_t)kMmGroups * kMmBBytes + (size_t)kMmRows * kMmRedStride * 4;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// until at most N of this warpgroup's committed product groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16 x bf16 -> f32: A from registers
// (a warp's 16 rows, as mma.sync m16n8k16's A), B K-major in shared memory;
// d is overwritten where accumulate == 0
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// out[M, N] = sum_{i<K} bf16(a + i) . b^T; a (M, D) f32, b (N, D) bf16.
// Warpgroup h of a block holds its slice of a (64 rows x 16 KS dimensions,
// f32) in registers as wgmma's A fragments, and its slice of b (128 columns x
// 16 KS dimensions) in shared memory as wgmma's K-major B, both loaded once;
// each iteration it adds i, packs its A fragments to bf16 and runs KS wgmma
// m64n128k16 into a product whose sum runs in wgmma's C for kMmChain
// iterations (a chain's first k-step zeroes it), then adds the product into
// its f32 sum: the same products as the plain version's, summed in another
// order, and no chain of the tensor cores' sums grows with K.  The two
// warpgroups of a block run the same steps out of phase, so one's
// conversions and adds overlap the other's products.  After the loop the two
// warpgroups' sums meet in shared memory; each block then publishes its
// tile's sums in `part` (tile, x) and counts itself in `count` (tile, zeroed
// by the caller), and the tile's last block to arrive adds the 4 in order of
// x and writes them (no block waits for another).  Dimensions past D meet
// zeros of b; rows past M are neither read nor written.  TIMED: the
// stage-timed build (the same arithmetic, so the same output).
template <int KS, bool TIMED>
__global__ void __launch_bounds__(kMmThreads, 1)
matmul_kernel(const float* __restrict__ a, const uint16_t* __restrict__ b,
              float* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
              int M, int N, int D, int K, long long* __restrict__ stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  StageClock<TIMED> clk;
  clk.start();
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7, w = (tid >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.z * kMmRows, col0 = blockIdx.y * kMmCols;
  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  const int dbase = 16 * KS * (2 * (int)blockIdx.x + wgi);  // the warpgroup's first dimension
  unsigned char* bs = smem + (size_t)wgi * kMmBBytes;
  float* red = reinterpret_cast<float*>(smem + (size_t)kMmGroups * kMmBBytes);
  // b's slice: bs[c][n][8 bf16] (core-matrix column c = dimensions dbase + 8 c),
  // zero past D
  for (int t = tid & 127; t < 2 * KS * kMmCols; t += 128) {
    const int n = t % kMmCols, c = t / kMmCols, d = dbase + 8 * c;
    *reinterpret_cast<uint4*>(bs + (size_t)c * kMmChunk + 16 * n) =
        d < D ? __ldg(reinterpret_cast<const uint4*>(b + (size_t)(col0 + n) * D + d))
              : make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // A fragments of k-step ks: rows 16 w + g and + 8, dimensions dbase + 16 ks
  // + 2 q (+1) and + 8 (+9): av[ks] = {(g, k), (g, k+1), (g+8, k), (g+8,
  // k+1), then the same at k + 8}
  const int r0 = row0 + 16 * w + g, r1 = r0 + 8;
  float av[KS][8];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = dbase + 16 * ks + 8 * h + 2 * q;
      const bool okd = d < D;
      const float2* p0 = reinterpret_cast<const float2*>(a + (size_t)r0 * D + d);
      const float2* p1 = reinterpret_cast<const float2*>(a + (size_t)r1 * D + d);
      const float2 x0 = okd && r0 < M ? __ldg(p0) : make_float2(0.0f, 0.0f);
      const float2 x1 = okd && r1 < M ? __ldg(p1) : make_float2(0.0f, 0.0f);
      av[ks][4 * h] = x0.x;
      av[ks][4 * h + 1] = x0.y;
      av[ks][4 * h + 2] = x1.x;
      av[ks][4 * h + 3] = x1.y;
    }
  uint64_t db[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) db[ks] = wg_desc(bs + (size_t)2 * ks * kMmChunk, kMmChunk, 128);
  float acc[64], prod[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = prod[j] = 0.0f;
  __syncthreads();
  clk.lap(kStLoad);
  // a product's sum runs in wgmma's C for kMmChain iterations, then is added
  // into the f32 sum; A is double-buffered, so a warpgroup issues iteration
  // i + 1's products before iteration i's have ended
  uint32_t af[2][KS][4];
  for (int i0 = 0; i0 < K; i0 += kMmChain) {
#pragma unroll
    for (int j = 0; j < kMmChain; ++j) {
      if (i0 + j < K) {
        const float fi = (float)(i0 + j);
        wg_wait<1>();  // the products that read af[j & 1] (iteration i - 2) have ended
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          af[j & 1][ks][0] = pack_bf16x2(av[ks][0] + fi, av[ks][1] + fi);
          af[j & 1][ks][1] = pack_bf16x2(av[ks][2] + fi, av[ks][3] + fi);
          af[j & 1][ks][2] = pack_bf16x2(av[ks][4] + fi, av[ks][5] + fi);
          af[j & 1][ks][3] = pack_bf16x2(av[ks][6] + fi, av[ks][7] + fi);
        }
        clk.lap(kStConvert);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_n128(prod, af[j & 1][ks], db[ks], j > 0 || ks > 0);
        wg_commit();
        clk.lap(kStMma);
      }
    }
    wg_wait<0>();
    clk.lap(kStMma);
#pragma unroll
    for (int u = 0; u < 64; ++u) acc[u] = acc[u] + prod[u];
    clk.lap(kStAcc);
  }
  // the block's sum: warpgroup 1's into `red`, then warpgroup 0 adds its own
  // (acc[4 t + u]: row 16 w + g + 8 (u >> 1), column 8 t + 2 q + (u & 1))
  float* rp = red + (size_t)(16 * w + g) * kMmRedStride + 2 * q;
  if (wgi == 1) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      *reinterpret_cast<float2*>(rp + 8 * t) = make_float2(acc[4 * t], acc[4 * t + 1]);
      *reinterpret_cast<float2*>(rp + 8 * kMmRedStride + 8 * t) =
          make_float2(acc[4 * t + 2], acc[4 * t + 3]);
    }
  }
  __syncthreads();
  if (wgi == 0) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float2* p0 = reinterpret_cast<float2*>(rp + 8 * t);
      float2* p1 = reinterpret_cast<float2*>(rp + 8 * kMmRedStride + 8 * t);
      const float2 v0 = *p0, v1 = *p1;
      *p0 = make_float2(acc[4 * t] + v0.x, acc[4 * t + 1] + v0.y);
      *p1 = make_float2(acc[4 * t + 2] + v1.x, acc[4 * t + 3] + v1.y);
    }
  }
  // the tile's sum: publish the block's, count it; the last block adds all 4
  __syncthreads();
  float* mine = part + ((size_t)tile * kMmSplit + blockIdx.x) * kMmTile;
  for (int t = tid; t < kMmTile / 4; t += kMmThreads) {
    const int r = t / (kMmCols / 4), c = 4 * (t % (kMmCols / 4));
    __stcg(reinterpret_cast<float4*>(mine + r * kMmCols + c),
           *reinterpret_cast<const float4*>(red + (size_t)r * kMmRedStride + c));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + tile, 1) == kMmSplit - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    const float* tp = part + (size_t)tile * kMmSplit * kMmTile;
    for (int t = tid; t < kMmTile / 4; t += kMmThreads) {
      const int r = t / (kMmCols / 4), c = 4 * (t % (kMmCols / 4));
      float4 sum = __ldcg(reinterpret_cast<const float4*>(tp + r * kMmCols + c));
#pragma unroll
      for (int x = 1; x < kMmSplit; ++x) {
        const float* px = tp + x * kMmTile + r * kMmCols + c;
        const float4 v = __ldcg(reinterpret_cast<const float4*>(px));
        sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
      }
      if (row0 + r < M) *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * N + col0 + c) = sum;
    }
  }
  clk.lap(kStEpilogue);
  clk.finish(stages, lane);
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

// x: (rows, 128) f32; out: (rows,) uint32, each row's least key.
extern "C" int qtt_redux_chain_launch(const void* x, void* out, int rows, int K, void* stream) {
  if (rows > 0) {
    const int per_block = kMinThreads / 32;
    redux_chain_kernel<<<(rows + per_block - 1) / per_block, kMinThreads, 0,
                         (cudaStream_t)stream>>>((const float*)x, (uint32_t*)out, rows, K);
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

// x, out: (8, N) f32; idx: (8, N) int32: the gather's floor.
extern "C" int qtt_gather_floor_launch(const void* x, const void* idx, void* out, int N, int K,
                                       void* stream) {
  if (N > 0) {
    gather_floor_kernel<<<(N + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                          (cudaStream_t)stream>>>((const float*)x, (const int32_t*)idx,
                                                  (float*)out, N, K);
  }
  return (int)cudaGetLastError();
}

namespace {

// the kernel for D's k-steps a warpgroup (D <= 128 KS)
template <bool TIMED>
const void* matmul_fn(int D) {
  const int ks = (D + 16 * kMmSlices - 1) / (16 * kMmSlices);
  if (ks <= 1) return (const void*)matmul_kernel<1, TIMED>;
  if (ks == 2) return (const void*)matmul_kernel<2, TIMED>;
  if (ks == 3) return (const void*)matmul_kernel<3, TIMED>;
  return (const void*)matmul_kernel<kMmMaxKs, TIMED>;
}

// x: the dimension slices' block, y: columns, z: rows
dim3 matmul_grid(int M, int N) {
  return dim3(kMmSplit, N / kMmCols, (M + kMmRows - 1) / kMmRows);
}

template <bool TIMED>
int matmul_launch(const void* a, const void* b, void* out, void* part, void* count, int M, int N,
                  int D, int K, void* stages, void* stream) {
  if (M > 0) {
    const void* fn = matmul_fn<TIMED>(D);
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmSmem);
    if (err != cudaSuccess) return (int)err;
    const float* a_ = (const float*)a;
    const uint16_t* b_ = (const uint16_t*)b;
    float* o_ = (float*)out;
    float* p_ = (float*)part;
    int* c_ = (int*)count;
    long long* s_ = (long long*)stages;
    void* args[] = {(void*)&a_, (void*)&b_, (void*)&o_, (void*)&p_, (void*)&c_, (void*)&M,
                    (void*)&N, (void*)&D, (void*)&K, (void*)&s_};
    err = cudaLaunchKernel(fn, matmul_grid(M, N), dim3(kMmThreads), args, kMmSmem,
                           (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, D) f32; b: (N, D) bf16; out: (M, N) f32; part: tiles x 4 x 64 x 128
// floats of scratch and count: tiles zeroed ints, tiles = ceil(M / 64) x (N /
// 128).  N % 128 == 0, D % 16 == 0 and D <= 512 are checked by the caller.
extern "C" int qtt_matmul_launch(const void* a, const void* b, void* out, void* part, void* count,
                                 int M, int N, int D, int K, void* stream) {
  return matmul_launch<false>(a, b, out, part, count, M, N, D, K, nullptr, stream);
}

// The stage-timed build: the arguments of qtt_matmul_launch, then stages, a
// zeroed (blocks, 7) int64 buffer.  Per block it receives the clock cycles
// of each stage summed over the block's warps (load, convert, mma, acc,
// epilogue), then the longest warp's own cycles and %globaltimer
// nanoseconds, from the kernel's start.
extern "C" int qtt_matmul_timed_launch(const void* a, const void* b, void* out, void* part,
                                       void* count, int M, int N, int D, int K, void* stages,
                                       void* stream) {
  if (!stages) return (int)cudaErrorInvalidValue;
  return matmul_launch<true>(a, b, out, part, count, M, N, D, K, stages, stream);
}

// Registers a thread, resident blocks an SM, threads a block and blocks of
// the grid of the matmul kernel (its stage-timed build where timed != 0) for
// (M, N, D), into out[0..3].
extern "C" int qtt_matmul_occupancy(int timed, int M, int N, int D, void* out) {
  const void* fn = timed ? matmul_fn<true>(D) : matmul_fn<false>(D);
  cudaFuncAttributes attr;
  int err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kMmSmem);
  if (!err) err = (int)cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kMmThreads, kMmSmem);
  if (err) return err;
  const dim3 grid = matmul_grid(M, N);
  int* o = (int*)out;
  o[0] = attr.numRegs;
  o[1] = blocks;
  o[2] = kMmThreads;
  o[3] = (int)(grid.x * grid.y * grid.z);
  return 0;
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
