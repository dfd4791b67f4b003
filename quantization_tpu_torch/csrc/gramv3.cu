// Gram-table sequential-beam encode (gramv3): for each frame, an M-wide beam
// sweeps the codebooks in order for `passes` passes and emits (B, nc) int32
// codebook indexes.  A candidate carries only its index row and its squared
// error; codeword j of codebook t scores
//   S(j) = (ss - Q(i)) + Q(j),  Q(j) = 2 (SG(j) - XC_t(j)),
//   SG(j) = sum_s Gt[s, t][ch_s, j]   (s = 0 .. nc-1, in that order),
// with Gt the codeword Gram matrix whose diagonal blocks are csq_t[j] / 2.
//
// Replaces: quantization_tpu/ops/gramv3.py::_gramv3_fori_kernel (per-pass
// uniform schedules) and ::_gramv3_kernel (any schedule), which are
// bit-identical by contract and differ only in how Mosaic emits the codebook
// loop.  This one kernel takes a pool bit word per pass.  Reproduced step
// for step: the M-way fan-out at t = 0, the score assembly above, the
// packed-mantissa selection (scores clamped at 0, the lane id in the 8 low
// mantissa bits, the truncated value carried forward), top-R per parent then
// the top M of the M*R pool with the parent id above the lane bits, the
// in-place R1 step, and the pass winner by packed (ss, m), whose truncated
// ss is the next pass's root score.  bf16 tables are summed in f32 in
// codebook order, int8 tables exactly in integers (the kernel works in
// units of the table scale).
//
// Bound: operations.  The TPU computes SG as a one-hot matmul; here a
// rescore row is a gather-sum of nc table rows against the FP32 add rate.
// Design: one warp owns one frame and runs its whole search with no
// barrier; lane l owns codewords 8l .. 8l+7, so a table row is one 16-byte
// (bf16) or 8-byte (int8) load a lane.  Latency holds it, so occupancy
// counts: 8 blocks of 4 warps an SM for int8, 7 for bf16 up to 8
// codebooks, 6 for bf16 at 16.
// - nc is a template parameter, and so is the step t of a candidate's
//   score row (a switch), so its own table rows are loaded before their
//   sums start (in groups of 4 for bf16, to keep to 64 registers).
// - At step t the rows s >= t are the same for every candidate (s > t the
//   root's, s = t the broadcast diagonal row), so up to 8 codebooks they
//   are staged once a step: bf16 keeps them unpacked in the warp's shared
//   memory and each candidate adds them in codebook order after its own t
//   rows; int8 sums them once, in 16-bit lanes of codewords XORed by 0x80
//   (unsigned, at most 16 x 255, no carry), and a candidate adds that sum
//   to its own rows' in one IADD a pair; the bias nc x 128 goes when the
//   sum becomes a float.  int8 stages them at 16 codebooks too.
// - A candidate's index row is one byte a codebook in its lane's registers
//   (one 64-bit word up to 8 codebooks, two at 16); the pool's reorder is a
//   shuffle from the parent's lane.
// - bf16 at 16 codebooks stages nothing (kAllRows): a candidate loads all
//   16 of its rows from the table, its own and the step's shared ones, and
//   adds them in codebook order.  The L1 cache serves the repeats: the
//   shared rows are the same for the step's 8 candidates, and a
//   candidate's own rows are often its predecessor's.  With no shared
//   memory the SM's 256 KB of L1 and shared memory can all be cache, and 6
//   blocks fit (80 registers).  Measured on the H100 at d1280, 8,192 frames,
//   altparity: 1.772 ms at 3 passes and 2.361 at 4, against 2.481 and
//   3.293 for the shared rows staged as f32 in 60 KB of dynamic shared
//   memory (114 registers, 3 blocks, the L1 60 KB).  Slower, each against
//   the staged 2.48 ms at 3 passes: the rows brought into a per-warp ring
//   in shared memory one candidate ahead, by bulk copies with an mbarrier
//   a slot (2.98-3.57 ms over depths 2 and 3, shared rows as bf16 slots or
//   f32; 2.61 copying only the rows whose id is new), or by cp.async
//   (2.54 with that deduplication; 3.47 without); own rows held in
//   registers a candidate ahead (2.61); more rows in flight a group (2.49,
//   3.07); L1 prefetches (3.12, 3.46); 4 to 8 blocks (1.83, 1.79, 2.04,
//   2.18 ms at 4, 5, 7 and 8).  int8 at 16 keeps its staged sum: every row
//   a candidate took 1.69 ms against 1.45.
// - The pool: each parent's keys are taken smallest first (a warp minimum
//   of the lanes' minima; the winner's lane then finds its next) while
//   they can still enter the pool's top M (after w, no key of the parent
//   gives a pool key below (w & ~(mbits | 255)) | m << 8) and are inserted
//   into a sorted list across the lanes, whose M-th entry is the bound.
//   That is the top M of every parent's top-R: the pool keys are distinct,
//   and a key above the M-th of a subset stays above the M-th of the whole.
//   A parent whose R keys all enter before the list fills takes them from
//   its lanes' keys sorted first, with nothing to check.
// Built with --fmad=false; Q = 2 (SG - XC) is formed as fma(SG, 2, -2 XC),
// which rounds once on an exact 2 (SG - XC), the same value.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCS = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// resident blocks an SM: at most 64 registers a thread for int8, 73 for
// bf16 up to 8 codebooks (whose shared rows take 3.5 KB of shared memory a
// warp at nc = 8), 80 for bf16 at 16 codebooks (no shared memory).  The
// stage-timed build takes the same bound; at 16 codebooks its clock reads
// make each load group land, so its split charges load more than the
// untimed kernel waits
template <bool I8, int NC>
constexpr int kMinBlocks = I8 ? 8 : NC <= 8 ? 7 : 6;
// every candidate adds all nc rows from the table, none staged: bf16 above
// 8 codebooks
template <bool I8, int NC>
constexpr bool kAllRows = !I8 && NC > 8;
constexpr int kMaxPool = 256;     // M * R
constexpr int kMaxPasses = 64;
constexpr uint32_t kLaneMask = 0xFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
// stages of the timed build (ops/gramv3.py::STAGES)
enum { kStRoot, kStLoad, kStScore, kStTopR, kStPool, kStReorder, kStPassEnd, kStages };

struct Args {
  const float* xc;          // (B, nc * 256), scale-divided for int8
  const int32_t* idx0;      // (B, nc)
  const float* ss0;         // (B,), scale-divided for int8
  const void* gt;           // (nc, nc * 256, 256) bf16 or int8: gt[t, s*256+i, j]
  int32_t* out;             // (B, nc)
  int B, R, passes;
  uint32_t pool[kMaxPasses];  // bit t of pool[p]: step t of pass p is a pool step
  long long* stages;          // timed build: (blocks, kStages + 2)
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-warp clock64() cycles of each stage; ON = false compiles to nothing.
// lap(s) charges the cycles since the last lap to stage s; landed(v) waits
// for v (a loaded value) first.  A copy of csrc/seqbeam.cu's, without the
// barrier stage: this kernel has no barrier.
template <bool ON>
struct StageClock {
  static constexpr bool kOn = ON;
  long long acc[kStages];
  long long t0, last, ns0;
  __device__ __forceinline__ void start() {
    if constexpr (ON) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) acc[s] = 0;
      ns0 = global_ns();
      t0 = last = clock64();
    }
  }
  __device__ __forceinline__ void lap(int s) {
    if constexpr (ON) {
      const long long now = clock64();
      acc[s] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void landed(uint32_t v) {
    if constexpr (ON) {
      asm volatile("" ::"r"(v));
      lap(kStLoad);
    }
  }
  // lane 0 of each warp adds its sums to the block's row, and the longest
  // warp's own cycles and nanoseconds stand for the block's
  __device__ __forceinline__ void finish(long long* stages, int lane) {
    if constexpr (ON) {
      if (lane == 0) {
        unsigned long long* r =
            reinterpret_cast<unsigned long long*>(stages + (size_t)blockIdx.x * (kStages + 2));
#pragma unroll
        for (int s = 0; s < kStages; ++s) atomicAdd(r + s, (unsigned long long)acc[s]);
        atomicMax(r + kStages, (unsigned long long)(clock64() - t0));
        atomicMax(r + kStages + 1, (unsigned long long)(global_ns() - ns0));
      }
    }
  }
};

// Packed selection key: the score clamped at 0, its 8 low mantissa bits
// replaced by the id.  Non-negative floats order like their bits.
__device__ __forceinline__ uint32_t pack_key(float s, uint32_t id) {
  const float v = s > 0.0f ? s : 0.0f;
  return (__float_as_uint(v) & ~kLaneMask) | id;
}

__device__ __forceinline__ uint32_t min8(const uint32_t (&k)[8]) {
  uint32_t m = k[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) m = min(m, k[q]);
  return m;
}

// The n smallest keys of a warp, in order (the fan-out): a lane's 8 keys
// sorted ascending first (a 19-comparator network), then each round the
// warp-wide minimum of the lanes' first keys, which its lane drops.  The
// keys are distinct, so the winner has one owner.  As in csrc/seqbeam.cu.
__device__ __forceinline__ void sort8(uint32_t (&k)[8]) {
  constexpr int net[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6},
                              {5, 7}, {1, 2}, {5, 6}, {0, 4}, {3, 7}, {1, 5}, {2, 6},
                              {1, 4}, {3, 6}, {2, 4}, {3, 5}, {3, 4}};
#pragma unroll
  for (int c = 0; c < 19; ++c) {
    const uint32_t lo = min(k[net[c][0]], k[net[c][1]]), hi = max(k[net[c][0]], k[net[c][1]]);
    k[net[c][0]] = lo;
    k[net[c][1]] = hi;
  }
}

__device__ __forceinline__ uint32_t pop_min(uint32_t (&k)[8]) {
  const uint32_t w = __reduce_min_sync(kFull, k[0]);
  if (k[0] == w) {
#pragma unroll
    for (int q = 0; q < 7; ++q) k[q] = k[q + 1];
    k[7] = kNone;
  }
  return w;
}

// A candidate's index row, byte s for codebook s: one word up to 8
// codebooks, two at 16 (codebooks 0-7 in lo, 8-15 in hi).
struct Ids2 {
  uint64_t lo, hi;
};
template <int NC>
using Ids = typename std::conditional<(NC <= 8), uint64_t, Ids2>::type;

__device__ __forceinline__ uint32_t byte_of(uint64_t row, int s) {
  return (uint32_t)(row >> (8 * s)) & kLaneMask;
}

__device__ __forceinline__ uint32_t byte_of(const Ids2& row, int s) {
  return s < 8 ? byte_of(row.lo, s) : byte_of(row.hi, s - 8);
}

__device__ __forceinline__ uint64_t with_byte(uint64_t row, int s, uint32_t v) {
  return (row & ~(0xFFull << (8 * s))) | ((uint64_t)v << (8 * s));
}

__device__ __forceinline__ Ids2 with_byte(Ids2 row, int s, uint32_t v) {
  if (s < 8)
    row.lo = with_byte(row.lo, s, v);
  else
    row.hi = with_byte(row.hi, s - 8, v);
  return row;
}

// byte s of a row whose byte s is 0 set to v
__device__ __forceinline__ void or_byte(uint64_t& row, int s, uint32_t v) {
  row |= (uint64_t)v << (8 * s);
}

__device__ __forceinline__ void or_byte(Ids2& row, int s, uint32_t v) {
  if (s < 8)
    or_byte(row.lo, s, v);
  else
    or_byte(row.hi, s - 8, v);
}

__device__ __forceinline__ uint64_t shfl_ids(uint64_t row, int src) {
  return __shfl_sync(kFull, row, src);
}

__device__ __forceinline__ Ids2 shfl_ids(const Ids2& row, int src) {
  return {__shfl_sync(kFull, row.lo, src), __shfl_sync(kFull, row.hi, src)};
}

__device__ __forceinline__ void unpack8(const uint4 w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);
    v[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
  }
}

// An int8 row of 8 codewords (two words) added into four 16-bit-lane sums
// of the codewords XORed by 0x80: sum[0] holds codewords 0 and 1, sum[1] 2
// and 3, sum[2] 4 and 5, sum[3] 6 and 7.
__device__ __forceinline__ void add_u8(const uint2 w, uint32_t (&sum)[4]) {
  const uint32_t x = w.x ^ 0x80808080u, y = w.y ^ 0x80808080u;
  sum[0] += __byte_perm(x, 0, 0x4140);
  sum[1] += __byte_perm(x, 0, 0x4342);
  sum[2] += __byte_perm(y, 0, 0x4140);
  sum[3] += __byte_perm(y, 0, 0x4342);
}

// The rows of a step that every candidate shares, staged: bf16 keeps rows
// 1 .. nc-1 as f32 in the warp's shared memory (f[s-1][h][lane] holds the
// lane's codewords 4h .. 4h+3, which only that lane writes and reads),
// int8 their one biased sum in registers.
template <bool I8, int NC>
struct Shared {
  float4 (*f)[2][32];
  uint32_t sum[4];
};

template <bool I8>
__device__ __forceinline__ const char* table_row(const char* gt_t, int s, uint32_t ch, int lane) {
  constexpr size_t esz = I8 ? 1 : 2;
  return gt_t + (((size_t)s * kCS + ch) * kCS + 8 * lane) * esz;
}

template <bool I8>
using RowWord = typename std::conditional<I8, uint2, uint4>::type;

template <bool I8>
__device__ __forceinline__ RowWord<I8> load_row(const char* gt_t, int s, uint32_t ch, int lane) {
  return __ldg(reinterpret_cast<const RowWord<I8>*>(table_row<I8>(gt_t, s, ch, lane)));
}

// Step t's shared rows s = t .. nc-1 of target block gt_t, with the root's
// ids `sol` (row t is the diagonal: any id gives it).  Above 8 codebooks
// (int8 alone: kAllRows) the rows are loaded in groups, as sg_row's, to
// keep to the registers.
template <bool I8, int NC>
__device__ __forceinline__ void load_shared(const char* gt_t, Ids<NC> sol, int t, int lane,
                                            Shared<I8, NC>& sh) {
  if constexpr (NC <= 8) {
    RowWord<I8> w[NC];
#pragma unroll
    for (int s = 1; s < NC; ++s)
      if (s >= t) w[s] = load_row<I8>(gt_t, s, byte_of(sol, s), lane);
    if constexpr (I8) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sh.sum[q] = 0;
#pragma unroll
      for (int s = 1; s < NC; ++s)
        if (s >= t) add_u8(w[s], sh.sum);
    } else {
#pragma unroll
      for (int s = 1; s < NC; ++s)
        if (s >= t) {
          float v[8];
          unpack8(w[s], v);
          sh.f[s - 1][0][lane] = make_float4(v[0], v[1], v[2], v[3]);
          sh.f[s - 1][1][lane] = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
  } else {
    static_assert(I8, "bf16 above 8 codebooks stages no rows");
    constexpr int G = 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) sh.sum[q] = 0;
#pragma unroll
    for (int g0 = 1; g0 < NC; g0 += G) {
      RowWord<I8> w[G];
#pragma unroll
      for (int s = g0; s < g0 + G && s < NC; ++s)
        if (s >= t) w[s - g0] = load_row<I8>(gt_t, s, byte_of(sol, s), lane);
#pragma unroll
      for (int s = g0; s < g0 + G && s < NC; ++s)
        if (s >= t) add_u8(w[s - g0], sh.sum);
    }
  }
}

// SG of this lane's codewords for a candidate with ids `row` whose rows
// s < T are its own and whose rows s >= T are the step's shared rows (T =
// NC: every row its own, the root's fan-out).  The own rows are loaded in
// groups (all of them for int8, 4 for bf16), each group's loads issued
// before any of its sums; the timed build waits for a group to land.
template <bool I8, int NC, int T, class Clock>
__device__ __forceinline__ void sg_row(const char* gt_t, Ids<NC> row, int lane,
                                       const Shared<I8, NC>& sh, float (&v)[8], Clock& clk) {
  constexpr int G = I8 ? 8 : 4;
  uint32_t acc[4];
  if constexpr (I8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = T < NC ? sh.sum[q] : 0u;
  }
#pragma unroll
  for (int g0 = 0; g0 < T; g0 += G) {
    constexpr int kG = G;  // rows of this group: min(G, T - g0)
    RowWord<I8> w[kG];
#pragma unroll
    for (int s = g0; s < g0 + kG && s < T; ++s)
      w[s - g0] = load_row<I8>(gt_t, s, byte_of(row, s), lane);
    if constexpr (Clock::kOn) {
      uint32_t all = 0;
#pragma unroll
      for (int s = g0; s < g0 + kG && s < T; ++s) all ^= w[s - g0].x ^ w[s - g0].y;
      clk.landed(all);
    }
#pragma unroll
    for (int s = g0; s < g0 + kG && s < T; ++s) {
      if constexpr (I8) {
        add_u8(w[s - g0], acc);
      } else if (s == 0) {
        unpack8(w[0], v);
      } else {
        float u[8];
        unpack8(w[s - g0], u);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = v[q] + u[q];
      }
    }
  }
  if constexpr (I8) {
    // 2^23 + u as a float is exact for u < 2^23: minus 2^23 and the bias
    // it is the exact integer sum
    constexpr float kBias = 8388608.0f + 128.0f * NC;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(__byte_perm(acc[q], 0x4B000000u, 0x7410)) - kBias;
      v[2 * q + 1] = __uint_as_float(__byte_perm(acc[q], 0x4B000000u, 0x7432)) - kBias;
    }
  } else {
#pragma unroll
    for (int s = T; s < NC; ++s) {
      const float4 lo = sh.f[s - 1][0][lane], hi = sh.f[s - 1][1][lane];
      const float u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = v[q] + u[q];
    }
  }
}

template <bool I8, int NC, class Clock>
__device__ __forceinline__ void sg_step(int t, const char* gt_t, Ids<NC> row, int lane,
                                        const Shared<I8, NC>& sh, float (&v)[8], Clock& clk) {
  if constexpr (NC <= 8) {
    switch (t) {
      case 1: sg_row<I8, NC, 1>(gt_t, row, lane, sh, v, clk); break;
      case 2: if constexpr (NC > 2) sg_row<I8, NC, 2>(gt_t, row, lane, sh, v, clk); break;
      case 3: if constexpr (NC > 3) sg_row<I8, NC, 3>(gt_t, row, lane, sh, v, clk); break;
      case 4: if constexpr (NC > 4) sg_row<I8, NC, 4>(gt_t, row, lane, sh, v, clk); break;
      case 5: if constexpr (NC > 5) sg_row<I8, NC, 5>(gt_t, row, lane, sh, v, clk); break;
      case 6: if constexpr (NC > 6) sg_row<I8, NC, 6>(gt_t, row, lane, sh, v, clk); break;
      default: if constexpr (NC > 7) sg_row<I8, NC, 7>(gt_t, row, lane, sh, v, clk); break;
    }
  } else {
    static_assert(NC == 16, "gramv3 takes 2, 4, 8 or 16 codebooks");
    switch (t) {
      case 1: sg_row<I8, NC, 1>(gt_t, row, lane, sh, v, clk); break;
      case 2: sg_row<I8, NC, 2>(gt_t, row, lane, sh, v, clk); break;
      case 3: sg_row<I8, NC, 3>(gt_t, row, lane, sh, v, clk); break;
      case 4: sg_row<I8, NC, 4>(gt_t, row, lane, sh, v, clk); break;
      case 5: sg_row<I8, NC, 5>(gt_t, row, lane, sh, v, clk); break;
      case 6: sg_row<I8, NC, 6>(gt_t, row, lane, sh, v, clk); break;
      case 7: sg_row<I8, NC, 7>(gt_t, row, lane, sh, v, clk); break;
      case 8: sg_row<I8, NC, 8>(gt_t, row, lane, sh, v, clk); break;
      case 9: sg_row<I8, NC, 9>(gt_t, row, lane, sh, v, clk); break;
      case 10: sg_row<I8, NC, 10>(gt_t, row, lane, sh, v, clk); break;
      case 11: sg_row<I8, NC, 11>(gt_t, row, lane, sh, v, clk); break;
      case 12: sg_row<I8, NC, 12>(gt_t, row, lane, sh, v, clk); break;
      case 13: sg_row<I8, NC, 13>(gt_t, row, lane, sh, v, clk); break;
      case 14: sg_row<I8, NC, 14>(gt_t, row, lane, sh, v, clk); break;
      default: sg_row<I8, NC, 15>(gt_t, row, lane, sh, v, clk); break;
    }
  }
}

// Keys of S(j) = (ss - Q(i)) + Q(j) over this lane's codewords, with
// Q = fma(SG, 2, -x2), x2 = 2 XC, and Q(i) fetched from the lane that owns
// codeword i.
__device__ __forceinline__ void row_keys(const float (&sg)[8], const float (&x2)[8], float ss,
                                         uint32_t i, int lane, uint32_t (&keys)[8]) {
  float Q[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) Q[q] = __fmaf_rn(sg[q], 2.0f, -x2[q]);
  // Q[i & 7] by a select tree on i's bits (an index would go through
  // local memory)
  const bool b0 = i & 1u, b1 = i & 2u, b2 = i & 4u;
  const float q01 = b0 ? Q[1] : Q[0], q23 = b0 ? Q[3] : Q[2];
  const float q45 = b0 ? Q[5] : Q[4], q67 = b0 ? Q[7] : Q[6];
  const float q03 = b1 ? q23 : q01, q47 = b1 ? q67 : q45;
  const float qi = __shfl_sync(kFull, b2 ? q47 : q03, (int)(i >> 3));
  const float base = ss - qi;
#pragma unroll
  for (int q = 0; q < 8; ++q) keys[q] = pack_key(base + Q[q], (uint32_t)(8 * lane + q));
}

// Insert g into the sorted list held across the lanes (entry lane + 32 c).
template <int CPL>
__device__ __forceinline__ void list_insert(uint32_t (&list)[CPL], uint32_t g, int lane) {
#pragma unroll
  for (int c = CPL - 1; c >= 0; --c) {
    const uint32_t up = __shfl_up_sync(kFull, list[c], 1);
    const uint32_t carry = __shfl_sync(kFull, list[c > 0 ? c - 1 : 0], 31);
    const uint32_t prev = lane > 0 ? up : c > 0 ? carry : 0u;
    list[c] = list[c] < g ? list[c] : max(prev, g);
  }
}

// 2 XC_t of this lane's codewords
__device__ __forceinline__ void load_x2(const float* xcb, int t, int lane, float (&x2)[8]) {
  const float4* p = reinterpret_cast<const float4*>(xcb + t * kCS + 8 * lane);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) x2[q] = 2.0f * v[q];
}

// Candidate m lives in lane m % 32, register slot m / 32.
template <int CPL, class V>
__device__ __forceinline__ V slot_of(const V (&a)[CPL], int c) {
  V v = a[0];
#pragma unroll
  for (int k = 1; k < CPL; ++k)
    if (c == k) v = a[k];
  return v;
}

template <bool I8, int NC, int M, bool TIMED>
__global__ void __launch_bounds__(kThreads, kMinBlocks<I8, NC>) gramv3_kernel(const Args a) {
  // the warp's shared rows (bf16 up to 8 codebooks, Shared::f)
  float4 (*rows)[2][32] = nullptr;
  if constexpr (NC <= 8) {
    __shared__ float4 shared_rows[kWarps][I8 ? 1 : NC - 1][2][32];
    rows = shared_rows[threadIdx.x >> 5];
  }
  constexpr int CPL = (M + 31) / 32;  // candidates a lane
  constexpr uint32_t mbits = (uint32_t)(M - 1) << 8;
  constexpr size_t kBlockBytes = (size_t)NC * kCS * kCS * (I8 ? 1 : 2);  // one target block
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= a.B) return;  // whole warps only: no barrier below
  StageClock<TIMED> clk;
  clk.start();
  const char* gt = reinterpret_cast<const char*>(a.gt);
  const float* xcb = a.xc + (size_t)b * NC * kCS;

  Ids<NC> sol{};  // the root's ids, byte s for codebook s
  {
    const int mine = lane < NC ? a.idx0[(size_t)b * NC + lane] : 0;
#pragma unroll
    for (int s = 0; s < NC; ++s) or_byte(sol, s, (uint32_t)__shfl_sync(kFull, mine, s));
  }
  float ss_root = a.ss0[b];
  Ids<NC> crow[CPL];  // the beam: ids and squared error of candidate lane + 32 c
  float css[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    crow[c] = sol;
    css[c] = 0.0f;
  }

  for (int p = 0; p < a.passes; ++p) {
    // ---- step 0: fan out from the root to its M best children
    {
      StageClock<false> off;  // step 0 is charged to root as a whole
      Shared<I8, NC> none;
      float x2[8], sg[8];
      uint32_t keys[8];
      load_x2(xcb, 0, lane, x2);
      sg_row<I8, NC, NC>(gt, sol, lane, none, sg, off);
      row_keys(sg, x2, ss_root, byte_of(sol, 0), lane, keys);
      sort8(keys);
      for (int n = 0; n < M; ++n) {
        const uint32_t w = pop_min(keys);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          if (n == lane + 32 * c) {
            css[c] = __uint_as_float(w & ~kLaneMask);
            crow[c] = with_byte(sol, 0, w & kLaneMask);
          }
      }
      clk.lap(kStRoot);
    }
    // ---- steps 1..nc-1
    for (int t = 1; t < NC; ++t) {
      const bool pool = (a.pool[p] >> t) & 1u;
      const char* gt_t = gt + (size_t)t * kBlockBytes;
      float x2[8];
      Shared<I8, NC> sh;
      sh.f = rows;
      load_x2(xcb, t, lane, x2);
      if constexpr (!kAllRows<I8, NC>) load_shared<I8, NC>(gt_t, sol, t, lane, sh);
      clk.landed(0u);
      uint32_t list[CPL];  // pool step: the smallest pool keys so far, entry lane + 32 c
#pragma unroll
      for (int c = 0; c < CPL; ++c) list[c] = kNone;
      uint32_t theta = kNone;  // the list's M-th entry
      int filled = 0;          // entries in the list while it can hold all of a parent's R
      const uint32_t it = byte_of(sol, t);  // every candidate's id at t is still the root's
      for (int m = 0; m < M; ++m) {
        const Ids<NC> row = shfl_ids(slot_of<CPL>(crow, m >> 5), m & 31);
        const float ss = __shfl_sync(kFull, slot_of<CPL>(css, m >> 5), m & 31);
        float sg[8];
        uint32_t keys[8];
        if constexpr (kAllRows<I8, NC>)
          sg_row<I8, NC, NC>(gt_t, row, lane, sh, sg, clk);  // rows s >= t: the root's
        else
          sg_step<I8, NC>(t, gt_t, row, lane, sh, sg, clk);
        row_keys(sg, x2, ss, it, lane, keys);
        clk.lap(kStScore);
        if (!pool) {
          // R1: each parent keeps its best child in place
          const uint32_t w1 = __reduce_min_sync(kFull, min8(keys));
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            if (m == lane + 32 * c) {
              css[c] = __uint_as_float(w1 & ~kLaneMask);
              crow[c] = with_byte(crow[c], t, w1 & kLaneMask);
            }
        } else if (filled + a.R <= M) {
          // the list is not full before this parent's R-th key: every key
          // enters, in order, with nothing to check
          const uint32_t pbits = (uint32_t)m << 8;
          sort8(keys);
          for (int k = 0; k < a.R; ++k)
            list_insert<CPL>(list, (pop_min(keys) & ~mbits) | pbits, lane);
          filled += a.R;
          theta = __shfl_sync(kFull, list[(M - 1) >> 5], (M - 1) & 31);
        } else {
          // this parent's keys, smallest first, while they can enter the
          // top M: a key k >= w1 gives the pool key (k & ~mbits) | m << 8,
          // at least (w1 & ~(mbits | 255)) | m << 8
          const uint32_t pbits = (uint32_t)m << 8;
          uint32_t lm = min8(keys);
          for (int k = 0; k < a.R; ++k) {
            const uint32_t w1 = __reduce_min_sync(kFull, lm);
            if (((w1 & ~(mbits | kLaneMask)) | pbits) > theta) break;
            const uint32_t g = (w1 & ~mbits) | pbits;
            if (g < theta) {
              list_insert<CPL>(list, g, lane);
              theta = __shfl_sync(kFull, list[(M - 1) >> 5], (M - 1) & 31);
            }
            if (lm == w1) {
              // its lane's next key, the smallest above w1: k - w1 - 1 keeps
              // the order of the keys above w1 and wraps the others above them
              uint32_t d[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) d[q] = keys[q] - w1 - 1u;
              const uint32_t next = min8(d);
              lm = next > ~w1 - 1u ? kNone : next + w1 + 1u;
            }
          }
        }
        clk.lap(kStTopR);
      }
      if (pool) {
        // ---- entry n of the list is candidate n: parent, id and ss
        int par[CPL];
        uint32_t j[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          par[c] = (int)((list[c] >> 8) & (uint32_t)(M - 1));
          j[c] = list[c] & kLaneMask;
          css[c] = __uint_as_float(list[c] & ~(mbits | kLaneMask));
        }
        clk.lap(kStPool);
        Ids<NC> nrow[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          Ids<NC> r{};
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const Ids<NC> v = shfl_ids(crow[k], par[c] & 31);
            if ((par[c] >> 5) == k) r = v;
          }
          nrow[c] = with_byte(r, t, j[c]);
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) crow[c] = nrow[c];
        clk.lap(kStReorder);
      }
    }
    // ---- pass end: the best candidate by packed (ss, m) becomes the root
    uint32_t k = kNone;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane + 32 * c < M) k = min(k, pack_key(css[c], (uint32_t)(lane + 32 * c)));
    const uint32_t w = __reduce_min_sync(kFull, k);
    const int best = (int)(w & kLaneMask);
    ss_root = __uint_as_float(w & ~kLaneMask);
    sol = shfl_ids(slot_of<CPL>(crow, best >> 5), best & 31);
    clk.lap(kStPassEnd);
  }
  if (lane < NC) a.out[(size_t)b * NC + lane] = (int32_t)byte_of(sol, lane);
  clk.finish(a.stages, lane);
}

// A kernel's entry (nullptr: not built).
using Kernel = const void*;

template <bool I8, int NC, int M, bool TIMED>
Kernel kernel_of() {
  return (Kernel)gramv3_kernel<I8, NC, M, TIMED>;
}

// The kernel a launch with (nc, M, g_dtype) runs; the timed build is
// instantiated for M = 8 only, and 16 codebooks for M = 8 only (auto's
// d1280 / 16 B rung; the timed build in bf16).
template <bool TIMED, bool I8, int NC>
Kernel kernel_by_m(int M) {
  if constexpr (NC == 16) {
    if constexpr (TIMED && I8) return nullptr;
    else return M == 8 ? kernel_of<I8, NC, 8, TIMED>() : nullptr;
  } else if constexpr (TIMED) {
    return M == 8 ? kernel_of<I8, NC, 8, true>() : nullptr;
  } else {
    switch (M) {
      case 8: return kernel_of<I8, NC, 8, false>();
      case 16: return kernel_of<I8, NC, 16, false>();
      case 32: return kernel_of<I8, NC, 32, false>();
      case 64: return kernel_of<I8, NC, 64, false>();
    }
    return nullptr;
  }
}

template <bool TIMED, bool I8>
Kernel kernel_by_nc(int nc, int M) {
  switch (nc) {
    case 2: return kernel_by_m<TIMED, I8, 2>(M);
    case 4: return kernel_by_m<TIMED, I8, 4>(M);
    case 8: return kernel_by_m<TIMED, I8, 8>(M);
    case 16: return kernel_by_m<TIMED, I8, 16>(M);
  }
  return nullptr;
}

template <bool TIMED>
Kernel kernel_for(int nc, int M, int g_dtype) {
  return g_dtype == 1 ? kernel_by_nc<TIMED, true>(nc, M)
                      : g_dtype == 0 ? kernel_by_nc<TIMED, false>(nc, M) : nullptr;
}

int launch(Kernel k, const void* xc, const void* idx0, const void* ss0, const void* gt,
           void* out, int B, int R, int passes, const void* pool_masks, long long* stages,
           cudaStream_t stream) {
  if (!k || passes > kMaxPasses || passes < 0 || R < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.xc = (const float*)xc;
  a.idx0 = (const int32_t*)idx0;
  a.ss0 = (const float*)ss0;
  a.gt = gt;
  a.out = (int32_t*)out;
  a.B = B; a.R = R; a.passes = passes;
  for (int p = 0; p < kMaxPasses; ++p)
    a.pool[p] = p < passes ? ((const uint32_t*)pool_masks)[p] : 0u;
  a.stages = stages;
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  if (blocks == 0) return (int)cudaGetLastError();
  void* args[] = {&a};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(kThreads), args, 0, stream);
}

}  // namespace

// xc (B, nc * 256) f32; idx0 (B, nc) int32; ss0 (B,) f32; gt (nc, nc * 256,
// 256) bf16 (g_dtype 0) or int8 (g_dtype 1); out (B, nc) int32.  pool_masks:
// `passes` host words, bit t set where step t is a pool step.  The caller
// checks shapes: nc in {2, 4, 8} with M in {8, 16, 32, 64}, or nc = 16 with
// M = 8; 1 <= R, M * R <= 256.
extern "C" int qtt_gramv3_launch(const void* xc, const void* idx0, const void* ss0,
                                 const void* gt, void* out, int B, int nc, int M, int R,
                                 int passes, const void* pool_masks, int g_dtype, void* stream) {
  if (M * R > kMaxPool) return (int)cudaErrorInvalidValue;
  return launch(kernel_for<false>(nc, M, g_dtype), xc, idx0, ss0, gt, out, B, R, passes,
                pool_masks, nullptr, (cudaStream_t)stream);
}

// The stage-timed build, at the serving path's beam only (M=8; bf16 only at
// nc = 16): the
// arguments of qtt_gramv3_launch, then stages, a zeroed (blocks, 9) int64
// buffer (blocks of 4 frames).  Per block it receives the clock64() cycles
// of each stage summed over the block's warps (root, load, score, topr,
// pool, reorder, pass_end), then the longest warp's own cycles and
// %globaltimer nanoseconds.
extern "C" int qtt_gramv3_timed_launch(const void* xc, const void* idx0, const void* ss0,
                                       const void* gt, void* out, int B, int nc, int M, int R,
                                       int passes, const void* pool_masks, int g_dtype,
                                       void* stages, void* stream) {
  if (M * R > kMaxPool || !stages) return (int)cudaErrorInvalidValue;
  return launch(kernel_for<true>(nc, M, g_dtype), xc, idx0, ss0, gt, out, B, R, passes,
                pool_masks, (long long*)stages, (cudaStream_t)stream);
}

// How the kernel that a launch with (nc, g_dtype) runs gets a step's table
// rows: 1 where every candidate loads all nc of them (kAllRows), 0 where
// the rows every candidate shares are staged once a step, -1 for no such
// kernel.
extern "C" int qtt_gramv3_all_rows(int nc, int g_dtype) {
  if (g_dtype != 0 && g_dtype != 1) return -1;
  const bool i8 = g_dtype == 1;
  switch (nc) {
    case 2: return i8 ? kAllRows<true, 2> : kAllRows<false, 2>;
    case 4: return i8 ? kAllRows<true, 4> : kAllRows<false, 4>;
    case 8: return i8 ? kAllRows<true, 8> : kAllRows<false, 8>;
    case 16: return i8 ? kAllRows<true, 16> : kAllRows<false, 16>;
  }
  return -1;
}

// Registers a thread and resident blocks an SM of the kernel that a launch
// with (nc, M, g_dtype) runs, the timed build's where timed != 0: out[0]
// registers, out[1] blocks an SM, out[2] threads a block, out[3] shared
// memory a block (bytes).
extern "C" int qtt_gramv3_occupancy(int nc, int M, int g_dtype, int timed, void* out) {
  const Kernel k = timed ? kernel_for<true>(nc, M, g_dtype) : kernel_for<false>(nc, M, g_dtype);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, k);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
  if (err) return err;
  int* o = (int*)out;
  o[0] = attr.numRegs;
  o[1] = blocks;
  o[2] = kThreads;
  o[3] = (int)attr.sharedSizeBytes;
  return 0;
}
