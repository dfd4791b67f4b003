// Fused sequential-beam encode (seqbeam v2, and v1 as a variant of the same
// kernel): for each frame, an M-wide beam sweeps the codebooks in order for
// `passes` passes and emits (B, nc) int32 codebook indexes.
//
// Replaces: quantization_tpu/ops/seqbeam.py::_seqbeam_kernel_v2 for e_dtype
// f32, bf16 and int8, any per-pass pool/R1 schedule, requant "step", "pass"
// and "bound", and lazy_r1; and, through qtt_seqbeam_v1_launch,
// quantization_tpu/ops/seqbeam.py::_seqbeam_kernel (v1).  The semantics are
// reproduced step for step: the root error recomputed from the winner every
// pass, the M-way fan-out at t = 0, the rescore E_m . C_t^T (bf16 x bf16 ->
// f32, or int8 x int8 -> int32 then dequantized by the row scale x codebook
// scale), the score assembly (v2: ((ss - 2 Ec) - ccn) + shared + 2 cross;
// v1: ((ss - 2 Ec + cc) + csq) + 2 (cross - q)), the packed-mantissa
// selection (scores clamped at 0, the lane id in the 8 low mantissa bits,
// the truncated value carried forward as next step's ss), the top-R per
// parent then top-M of the M*R pool (v2: the parent id above the lane bits;
// v1: the truncated values repacked with the pool lane m*R + r, parent =
// lane / R), the in-place R1 step, the extension E_child = E_parent +
// (c_t[j] - c_t[i]) with int8 requantization (round half to even): "step"
// requantizes each row with scale max|e| * (1/127); "pass" keeps the root's
// scale for the whole pass and adds round(dc8 * (csc / s0)), clipped;
// "bound" grows the parent's scale by cmax_t / 127.  lazy_r1: an R1 step
// that is neither first nor last skips its extension; the next (pool) step
// adds Gx_t[j'] - Gx_t[i'] to its rescore and applies both deltas in its
// move, j' taken from the destination's parent slot.  The pass-end winner
// is the packed (ss, m) minimum.
//
// Bound: operations, in principle.  Per frame and pass the rescore is
// (1 + (nc-1) M) products of length D against all 256 codewords; the rest
// is O(M * D) or O(M * 256) per step.  On the card neither peak binds: a
// block-step goes to issuing the per-row work of the extension (about 10
// instructions an element for int8 E) and the selection, and to waiting on
// L2 for each codebook (128 KB a block-step at d512 int8; 12.9 GB for
// 32,768 frames).  PERF.md has the stage breakdown.
//
// Design.  One block of 256 threads owns F frames (F * M <= 64 candidate
// rows) and keeps in shared memory, for all passes, their candidate error
// rows E (double-buffered for the beam reorder), the root errors, the
// 64 x 256 f32 score tile X and the beam bookkeeping.
//
// bf16 and int8 E (the auto ladder's rungs and every v2 variant with those E
// types): the rescore runs on wgmma, two warpgroups each owning 128
// codewords (m64n128k32 s8 or m64n128k16 bf16; the block's rows are one m64
// tile), both operands in shared memory without swizzle.  E is K-chunked
// for the descriptor (the 16-byte K pieces of all rows one after another),
// each piece padded by 16 bytes so that the extension's row accesses miss no
// bank.  Codebook t reaches a ring of two 32 KB chunks (256 codewords x 128
// bytes of K, so arranged by the wrapper) by cp.async.bulk on an mbarrier,
// issued by one thread as soon as a slot is free: the next step's first two
// chunks, or the next pass's root's, load while this step selects and
// extends.  The root rows join the ring as a bf16 A operand written into
// E[1].  The Gmod score rows of step t + 1 arrive by cp.async during step t,
// and each extension's codeword rows (C_t[j] of every row, C_t[i] of every
// frame) are staged by cp.async into X's space (C_0[i] into E[1]) once the
// selection is done.  Where no block fits that (bf16 E with M=64 at d384-512
// or M=32 from d896, int8 E with M=64 from d640), the compact layout puts
// the ring in X's space, loads it only while its rescore runs, and reads
// the extensions' rows from L2.  Where neither fits (bf16 E with M=64 from
// d640; f32 E with M=32 from d768 or M=64 from d384, and v1 from M=24 at
// d1024 down to M=56-64 at d384), the spill layout moves E out of the
// block: bf16 E keeps one E buffer, the wgmma operand, and a pool step
// copies it to a global scratch slot and extends the children from that
// copy; f32 E keeps both buffers in the slot and reads them through L2.  A
// block claims a slot by an atomic when it starts and frees it when it
// ends, so the wrapper sizes the scratch by the SMs, not by the grid.
// Above D = 1024 only auto's two M=8 rungs run, in instantiations of their
// own whose extension holds 10 chunks a lane (the others keep 8, and their
// registers): their full layout reads the fan-out's rows from L2 and
// stages the later steps' only, which keeps 4 frames a block for int8 E at
// D = 1280 (2 for bf16 E).
// The int8 extension turns bytes into floats and back with byte permutes
// and exact float adds, not on the conversion pipe, which issues at a
// quarter of the rate.
//
// f32 E (v1, the training search, an explicit e_dtype="f32"): E stays
// row-major f32 in both buffers, which leaves no room for a ring of its own
// beside X.  The rescore read its B fragments from L2 in its k loop, a round
// trip each k step with nothing in flight across them: 54% of a block-step
// at d512 and 35% at d256 for v1 (PERF.md, PR 8).  It now runs on wgmma
// with A taken from registers (each thread loads its f32 E elements from
// shared memory and rounds them to bf16, rows past the last zero, the next
// chunk's while the current chunk's products run; every bf16 x bf16
// product is exact in f32, so only the order of the f32 sums differs from
// the plain version's) and B from K2's bf16 chunks through a ring of two
// 32 KB slots in X's space: slot 0 lies past the extensions' staged
// codeword rows and is loaded as soon as the selection has read X, slot 1
// lies on the staged rows and is loaded once the extension has read them.
// Four 16 KB slots, and eight with four of them in the E buffer the
// rescore does not read, measured slower: a chunk's barrier and wait, not
// the bytes in flight, hold it.  The extensions' codeword rows are staged
// by cp.async as wgmma's are, and the score rows (v1: q_t[sol_t, :] and
// |c_t|^2; v2: Gmod_t[sol_t, :]) arrive a step ahead by cp.async.  Where
// the staged rows do not fit (f32 E from M=24 at some D), the compact
// layout keeps one slot in X's space and reads the extensions' rows from
// L2.  The spill layout (C2's f32 beams keep E in the global slot) keeps
// the mma.sync rescore, reading the codebook from L2.
//
// Selection runs one warp per candidate row (each lane's 8 packed keys
// sorted, then R rounds of __reduce_min_sync over the lanes' first keys);
// the pool ranks every entry of a frame's M*R keys by counting the smaller
// ones, all warps at once (one warp a frame left most warps idle).  All f32
// arithmetic is built with --fmad=false so that each rounding step matches
// the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCS = 256;          // codebook size (SEQBEAM_SUPPORTED)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = 64;
// The extension holds a row's D / 128 chunks of 4 values a lane in
// registers, sized by the instantiation: every beam up to D = 1024 compiles
// with room for 8, and the wide instantiations (auto's two M=8 rungs, up to
// D = 1280) with room for 10, so that the narrow ones keep their registers.
constexpr int kNarrowChunks = 8;
constexpr int kWideChunks = 10;
constexpr int kNarrowDim = kNarrowChunks * 128;
constexpr int kWideDim = kWideChunks * 128;
constexpr int kMaxNc = 16;
constexpr int kChunk = 32768;     // a ring chunk: 256 codewords x 128 bytes of K
constexpr int kKF = kChunk / (kCS * 2);  // f32 E: bf16 elements of K a ring chunk
constexpr int kMaxRows = 64;      // frames x candidates per block
constexpr int kXS = kCS + 8;      // padded row stride of the score tile (floats)
constexpr size_t kMaxSmem = 232448;
constexpr uint32_t kLaneMask = 0xFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr float kInv127 = (float)(1.0 / 127.0);

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };
// shared-memory layouts, tried in this order (see make_layout)
enum { kFull = 0, kCompact = 1, kSpill = 2 };
enum { kStep = 0, kPass = 1, kBound = 2 };
// the stages of the stage-timed build, in the columns of its output
enum { kStRoot, kStSrow, kStRescore, kStSelect, kStPool, kStReorder, kStExtend, kStBarrier,
       kStages };
constexpr int kStageCols = kStages + 2;  // then the block's own cycles and nanoseconds

struct Args {
  const float* x;           // (B, D)
  const int32_t* idx0;      // (B, nc) initial solution
  const uint16_t* C;        // (nc * 256, D) bf16 centers
  const uint16_t* gmod;     // v2: (nc * 256, 256) bf16: csq[t, j] - 2 c_t(i).c_t(j)
  const int8_t* C8;         // (nc * 256, D) int8 centers (int8 E only)
  const float* csc;         // (nc,) int8 center scales (int8 E only)
  const float* cmax;        // (nc,) max_d (max_j - min_j) c8 (requant "bound" only)
  const uint16_t* gx;       // (nc * 256, 256) bf16 C_{t-1} . C_t^T (lazy_r1 only)
  const float* qg;          // v1: (nc * 256, 256) f32 Gram of the bf16 centers
  const float* csq;         // v1: (nc * 256,) f32 |c|^2 of the f32 centers
  const unsigned char* cpb; // bf16 and int8 E: the bf16 centers as ring chunks, per codebook
                            // (2 D / 128) x [8 16-byte K pieces][256 codewords][16 bytes]
  const unsigned char* cpi; // int8 E: the int8 centers as ring chunks (D / 128 per codebook)
  int32_t* out;             // (B, nc)
  long long* stages;        // (blocks, kStageCols) int64, zeroed (stage-timed build only)
  unsigned char* spill;     // spill layout: nslots scratch slots of Layout::spill_bytes
  int* slots;               // spill layout: nslots zeroed claim flags
  int B, D, nc, R, passes, F;
  int kind;                 // the layout: kFull, kCompact or kSpill (see make_layout)
  int nslots;
  uint32_t pool[kMaxPasses];  // bit t of pool[p]: step t of pass p is a pool step
};

struct Layout {
  int rows;          // F * M candidate rows
  int xrows;         // rows rounded up to the rescore's 16-row tiles
  int e_stride;      // wgmma (bf16 and int8 E): bytes between E's 16-byte K pieces;
                     // f32 E: bytes a row (both padded: no bank conflicts)
  int root_stride;   // wgmma: bytes between the bf16 root rows' 16-byte K pieces
  int er_stride;     // floats per root-error row
  int slots;         // f32 E outside the spill layout: ring slots (2 full, 1 compact)
  bool ahead;        // wgmma, not compact: the ring has room of its own and loads a
                     // rescore ahead
  bool stage;        // full layout (not spill): the extensions' codeword rows are staged in
                     // X's space
  bool fan;          // stage: the fan-out's bf16 rows too (not in the wide instantiations)
  size_t e0, e1, er, xs, srow, sc0, sc1, rsc, ss, ss0, ch0, ch1, sol, selj, selp, jdef, rkeys,
      ring, bars, slot;  // f32 E: ring holds slot 0, xs slot 1
  size_t total;
  size_t spill_bytes;  // spill layout: the block's global scratch slot (wgmma: E[0]'s
                       // reorder copy; f32 E: both E buffers, spill_bytes / 2 apart)
};

// Beams that may take the spill layout.  Each compiles a second kernel for
// it (SPILL), so that E's buffers stay in shared memory, as the compiler sees
// them, in the kernel of the full and compact layouts; the others compile
// without it.
__host__ __device__ constexpr bool spills(int et, int M) { return et == kF32 ? M >= 24 : M >= 64; }
// Beams that may take the compact layout; the others compile to the full
// layout alone (outside the spill kernel).
__host__ __device__ constexpr bool compacts(int et, int M) {
  return et == kF32 ? spills(et, M) : M >= 32;
}

__host__ __device__ inline size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off = (at + bytes + 15) & ~(size_t)15;
  return at;
}

__host__ __device__ inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// bf16 and int8 E (wgmma): E K-chunked with room for the m64 tile to read
// past the last row (int8 E at d512 with F = 8 fits with 1,104 bytes left);
// X's space also holds the extensions' staged codeword rows (the fan-out's
// bf16 C_0[j] of every row too); the score rows are bf16, double-buffered;
// a ring of two chunks and their mbarriers.  kCompact, for the wide beams
// at large D where that does not fit: the ring lies in X's space and is
// loaded only while its rescore runs, and the extensions read their
// codeword rows from L2.  f32 E: E row-major, the score rows f32 (v2's
// Gmod rows bf16 in f32's room), double-buffered, with v1's |c|^2 row after
// each buffer's F rows; X's space holds the staged codeword rows and ring
// slot 0 past them, slot 1 on them (kFull), or one slot (kCompact).  kSpill,
// where neither fits: wgmma as kCompact, but E[1] holds only the root's
// bf16 rows; f32 E wholly in the global slot, single f32 score rows and no
// ring; a 16-byte cell holds the slot's number.  `wide` (D > 1024, auto's
// M=8 rungs): the fan-out's extension reads its bf16 rows from L2, so that
// X's space need not hold them and int8 E keeps 4 frames a block at D =
// 1280 in the full layout; the later steps' rows are staged as before.
__host__ __device__ inline Layout make_layout(int et, int M, int F, int D, int nc, int R,
                                              bool lazy, int kind, bool wide) {
  Layout L;
  const bool wg = et != kF32;
  const bool spill = kind == kSpill;
  const bool rg = !wg && !spill;  // f32 E on the ring
  L.ahead = wg && kind == kFull;
  L.stage = kind == kFull;
  L.fan = L.stage && !wide;
  const int esize = et == kF32 ? 4 : (et == kBF16 ? 2 : 1);
  L.rows = F * M;
  L.xrows = (L.rows + 15) / 16 * 16;
  L.er_stride = D + 4;
  L.root_stride = (F + 1) * 16;
  const size_t rows = (size_t)L.rows;
  size_t e0bytes, e1bytes;
  if (wg) {
    // the m64 tile reads 64 - rows rows past the last K piece's rows; E[1]
    // also holds the bf16 root rows during the root's rescore
    L.e_stride = (L.rows + 1) * 16;
    const size_t kbytes = (size_t)(D * esize / 16) * L.e_stride;
    const size_t root = (size_t)(D / 8) * L.root_stride + (64 - F) * 16;
    e0bytes = max_sz(kbytes + (64 - L.rows) * 16, spill ? 0 : root);
    e1bytes = spill ? root : e0bytes;
    L.spill_bytes = spill ? kbytes : 0;
  } else {
    L.e_stride = D * esize + 16;
    e0bytes = e1bytes = spill ? 0 : rows * L.e_stride;
    L.spill_bytes = spill ? 2 * rows * L.e_stride : 0;
  }
  size_t off = 0;
  L.e0 = take(&off, e0bytes);
  L.e1 = take(&off, e1bytes);
  L.er = take(&off, (size_t)F * L.er_stride * 4);
  size_t xbytes = (size_t)L.xrows * kXS * 4;
  // f32 E: the offset of ring slot 0 in X's space (full: past the staged
  // rows and slot 1, which lies on them; compact: at its start, no slot 1)
  const size_t lo = L.stage ? max_sz((rows + F) * 2 * D, (size_t)kChunk) : 0;
  L.slots = !rg ? 0 : L.stage ? 2 : 1;
  if (L.ahead) xbytes = max_sz(xbytes, max_sz((rows + F) * D * esize, L.fan ? rows * 2 * D : 0));
  else if (wg) xbytes = max_sz(xbytes, 2 * (size_t)kChunk);
  else if (rg) xbytes = max_sz(xbytes, lo + (size_t)kChunk);
  L.xs = take(&off, xbytes);
  L.srow = take(&off, wg ? (size_t)2 * F * kCS * 2
                         : (size_t)(rg ? 2 * (F + 1) : F) * kCS * 4);
  L.sc0 = take(&off, rows * 4);
  L.sc1 = take(&off, rows * 4);
  L.rsc = take(&off, rows * 4);
  L.ss = take(&off, rows * 4);
  L.ss0 = take(&off, (size_t)F * 4);
  L.ch0 = take(&off, rows * nc * 4);
  L.ch1 = take(&off, rows * nc * 4);
  L.sol = take(&off, (size_t)F * nc * 4);
  L.selj = take(&off, rows * 4);
  L.selp = take(&off, rows * 4);
  L.jdef = take(&off, lazy ? rows * 4 : 0);  // lazy_r1 only
  L.rkeys = take(&off, rows * R * 4);
  L.ring = L.ahead ? take(&off, 2 * (size_t)kChunk) : L.xs + (rg ? lo : 0);
  L.bars = take(&off, wg || rg ? 16 : 0);
  L.slot = take(&off, spill ? 16 : 0);
  L.total = off;
  return L;
}

__device__ __forceinline__ float bf2f(uint16_t h) { return __uint_as_float((uint32_t)h << 16); }

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-warp clock64() cycles of each stage; ON = false compiles to nothing.
// lap(s) charges the cycles since the last lap to stage s; sync(s) charges
// the work before the barrier to s and the wait in it to kStBarrier.
template <bool ON>
struct StageClock {
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
  __device__ __forceinline__ void sync(int s) {
    lap(s);
    __syncthreads();
    lap(kStBarrier);
  }
  // lane 0 of each warp adds its sums to the block's row; thread 0 also
  // writes the block's own cycles and nanoseconds
  __device__ __forceinline__ void finish(long long* row, int tid) {
    if constexpr (ON) {
      if ((tid & 31) == 0)
#pragma unroll
        for (int s = 0; s < kStages; ++s)
          atomicAdd(reinterpret_cast<unsigned long long*>(row + s), (unsigned long long)acc[s]);
      if (tid == 0) {
        row[kStages] = clock64() - t0;
        row[kStages + 1] = global_ns() - ns0;
      }
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- Hopper's asynchronous copies and warpgroup products

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one 16-byte cp.async; wait_all also waits for every earlier group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// generic-proxy writes of shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: `bytes` from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// A copy that never lands (a fault in its addresses) traps after about 2^28
// polls, seconds at the least, rather than hold the card.
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
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32; scale_d = 0 starts the sum
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
               ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
               ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
               ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
               "}, %64, %65, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                 "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                 "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
                 "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
                 "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
                 "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
                 "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
                 "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
                 "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
                 "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
                 "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
               : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16 x bf16 -> f32
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
               ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
               ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
               ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
               "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
               : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16 x bf16 -> f32, A from registers
// (each warp's 16 rows in the m16n8k16 A fragment layout)
__device__ __forceinline__ void wgmma_bf16_ra(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
               ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
               ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
               ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Packed selection key: the score clamped at 0, its 8 low mantissa bits
// replaced by the lane id.  Non-negative floats order like their bits.
__device__ __forceinline__ uint32_t pack_key(float s, uint32_t id) {
  const float v = s > 0.0f ? s : 0.0f;
  return (__float_as_uint(v) & ~kLaneMask) | id;
}

// Warp-wide minimum of the keys held by the lanes (an R1 step's best child).
__device__ __forceinline__ uint32_t warp_min(const uint32_t (&keys)[8]) {
  uint32_t m = keys[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) m = min(m, keys[q]);
  return __reduce_min_sync(0xFFFFFFFFu, m);
}

// The n smallest keys of a warp, in order (the top-R and the fan-out): a
// lane's 8 keys sorted ascending first (a 19-comparator network), then each
// round the warp-wide minimum of the lanes' first keys, which its lane drops
// (pop_min).  The keys are distinct, so the winner has one owner.
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
  const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, k[0]);
  if (k[0] == w) {
#pragma unroll
    for (int q = 0; q < 7; ++q) k[q] = k[q + 1];
    k[7] = kNone;
  }
  return w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float clip127(float v) { return fminf(fmaxf(v, -127.0f), 127.0f); }

// int8 <-> f32 without the conversion pipe, which issues a quarter as fast:
// the int8 extension is mostly conversions.  Byte i of w, biased to [0,
// 255] by w ^ 0x80808080, set into the mantissa of 2^23 by one byte permute:
// a float 2^23 + 128 + the signed byte, exact.
__device__ __forceinline__ float biased_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i));
}

// The four signed bytes of w as exact floats.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&v)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = biased_byte(u, i) - 8388736.0f;
}

// rintf(x) (half to even) for |x| < 2^22: the sum with 1.5 * 2^23 rounds to
// an integer, which its low mantissa bits hold (its low byte is the int8)
__device__ __forceinline__ float round_even(float x) { return (x + 12582912.0f) - 12582912.0f; }
__device__ __forceinline__ uint32_t round_even_bits(float x) {
  return __float_as_uint(x + 12582912.0f);
}

// The low bytes of four words as one word (bytes 0..3 from a, b, c, d).
__device__ __forceinline__ uint32_t low_bytes4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive elements (k, k+1) of f32 row r of A, rounded to a bf16
// pair as the TPU kernel's matmul casts its operand; rows at or past `rows`
// read as zero.
__device__ __forceinline__ uint32_t load_a(const unsigned char* A, int stride, int rows, int r, int k) {
  if (r >= rows) return 0u;
  const float2 v = *reinterpret_cast<const float2*>(A + (size_t)r * stride + (size_t)k * 4);
  return pack_bf16x2(v.x, v.y);
}

// f32 E in the spill layout: X[r, n] = sum_k bf16(A[r, k]) * C_t[n, k] in
// f32 for r < 16 * mtiles and all 256 codewords n, on mma.sync.  Warp w
// owns codewords [32 w, 32 w + 32) and reads their rows of C_t from L2.
__device__ void rescore_bf16(const unsigned char* A, int stride, int rows, int mtiles,
                             const uint16_t* __restrict__ Ct, int D, float* X, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int n0 = warp * 32;
  for (int mt0 = 0; mt0 < mtiles; mt0 += 4) {
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mi][nt][u] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint16_t* bp = Ct + (size_t)(n0 + nt * 8 + g) * D + k0 + 2 * q;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mt0 + mi < mtiles) {
          const int r0 = (mt0 + mi) * 16 + g, r1 = r0 + 8;
          const uint32_t a[4] = {load_a(A, stride, rows, r0, k0 + 2 * q),
                                 load_a(A, stride, rows, r1, k0 + 2 * q),
                                 load_a(A, stride, rows, r0, k0 + 8 + 2 * q),
                                 load_a(A, stride, rows, r1, k0 + 8 + 2 * q)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], a, b[nt]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mt0 + mi < mtiles) {
        const int r0 = (mt0 + mi) * 16 + g, r1 = r0 + 8;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + nt * 8 + 2 * q;
          X[r0 * kXS + col] = acc[mi][nt][0];
          X[r0 * kXS + col + 1] = acc[mi][nt][1];
          X[r1 * kXS + col] = acc[mi][nt][2];
          X[r1 * kXS + col + 1] = acc[mi][nt][3];
        }
      }
    }
  }
}

// The m64n128 sums of warpgroup tid / 128 into X's rows below `rows`:
// thread (warp w, lane l) of a warpgroup holds rows 16 w + l / 4 (+ 8),
// columns 8 j + 2 (l % 4) (+ 1), j < 16.  I8: s32 sums dequantized by rsc[r].
template <bool I8, class Acc>
__device__ __forceinline__ void store_sums(const Acc (&d)[64], const float* rsc, float* X, int rows,
                                           int tid) {
  const int wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), r1 = r0 + 8;
  const float s0 = I8 && r0 < rows ? rsc[r0] : 1.0f, s1 = I8 && r1 < rows ? rsc[r1] : 1.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = wg * 128 + 8 * j + 2 * (l & 3);
    if (r0 < rows) {
      X[r0 * kXS + col] = I8 ? (float)d[4 * j] * s0 : (float)d[4 * j];
      X[r0 * kXS + col + 1] = I8 ? (float)d[4 * j + 1] * s0 : (float)d[4 * j + 1];
    }
    if (r1 < rows) {
      X[r1 * kXS + col] = I8 ? (float)d[4 * j + 2] * s1 : (float)d[4 * j + 2];
      X[r1 * kXS + col + 1] = I8 ? (float)d[4 * j + 3] * s1 : (float)d[4 * j + 3];
    }
  }
}

// f32 E outside the spill layout: X[r, n] = sum_k bf16(A[r, k]) * C_t[n,
// k] in f32 for r < rows and all 256 codewords n, on wgmma.  A: f32 rows
// (`stride` bytes a row), rounded to bf16 into registers as they are
// loaded, rows at or past `rows` zero; chunk c + 1's while chunk c's
// products run.  B: the codebook's D / 64 chunks of 32 KB (K2's: [8 16-byte
// K pieces][256 codewords][16 bytes]), chunk c of the rescore in ring slot
// c % S (`slot`, completing on full[c % S]); the caller has issued the
// first chunks, and after both warpgroups are done with chunk c thread 0
// refills its slot with chunk c + S of this rescore.  Warpgroup w owns
// codewords [128 w, 128 w + 128).
template <bool TIMED, class Slot, class Issue>
__device__ void wg_rescore_f32(const unsigned char* A, int stride, int rows, int nchunks, int S,
                               const Slot& slot, uint64_t* full, int& g, const Issue& issue,
                               float* X, StageClock<TIMED>& clk, int stage, int tid) {
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  const int wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
  const int r0 = 16 * w + (l >> 2), r1 = r0 + 8, kq = 2 * (l & 3);
  // chunk c's A fragments, rounded to bf16
  auto load = [&](int c, uint32_t (&fa)[kKF / 16][4]) {
#pragma unroll
    for (int s = 0; s < kKF / 16; ++s) {
      const int k = kKF * c + 16 * s + kq;
      fa[s][0] = load_a(A, stride, rows, r0, k);
      fa[s][1] = load_a(A, stride, rows, r1, k);
      fa[s][2] = load_a(A, stride, rows, r0, k + 8);
      fa[s][3] = load_a(A, stride, rows, r1, k + 8);
    }
  };
  // chunk c (A in `fa`, loaded): wait for its slot, run its products, then
  // load chunk c + 1's A into `next` while they run; once both warpgroups
  // are done with the slot, refill it with chunk c + S
  auto step = [&](int c, const uint32_t (&fa)[kKF / 16][4], uint32_t (&next)[kKF / 16][4]) {
    mbar_wait(full + g % S, (g / S) & 1);
    const unsigned char* B = slot(g % S) + wg * 128 * 16;
    wg_fence();
#pragma unroll
    for (int s = 0; s < kKF / 16; ++s)
      wgmma_bf16_ra(d, fa[s], wg_desc(B + s * 2 * kCS * 16, kCS * 16, 128), c | s);
    wg_commit();
    if (c + 1 < nchunks) load(c + 1, next);
    wg_wait0();
    clk.sync(stage);  // both warpgroups are done with the slot
    if (tid == 0 && c + S < nchunks) issue(g + S);
    ++g;
  };
  uint32_t fa0[kKF / 16][4], fa1[kKF / 16][4];
  load(0, fa0);
  for (int c = 0; c < nchunks; c += 2) {  // nchunks is even
    step(c, fa0, fa1);
    step(c + 1, fa1, fa0);
  }
  store_sums<false>(d, nullptr, X, rows, tid);
}

// bf16 and int8 E: X[r, n] for r < rows and all 256 codewords n, on wgmma.
// A: K-chunked rows (`stride` bytes between 16-byte K pieces; the m64 tile
// reads past `rows`, and those rows' sums are dropped).  B: `nchunks`
// chunks of the codebook taken from the ring in sequence, chunk g in slot
// g & 1; after both warpgroups are done with a slot, thread 0 refills it
// with chunk g + 2 (`issue`).  `ahead`: the ring is loaded a rescore ahead
// (its first two chunks are in flight already); else the ring lies in X's
// space, its first two chunks are issued here and no chunk past this
// rescore's.  Warpgroup w owns codewords [128 w, 128 w + 128).  I8: s8 x s8
// -> s32, dequantized by rsc[r]; else bf16 -> f32.
template <bool I8, bool TIMED, class Issue>
__device__ void wg_rescore(const unsigned char* A, int stride, int nchunks, unsigned char* ring,
                           uint64_t* full, int& g, bool ahead, const Issue& issue,
                           const float* rsc, float* X, int rows, StageClock<TIMED>& clk,
                           int stage, int tid) {
  using Acc = typename std::conditional<I8, int, float>::type;
  Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  const int wg = tid >> 7;
  if (!ahead && tid == 0) {
    issue(g);
    if (nchunks > 1) issue(g + 1);
  }
  for (int c = 0; c < nchunks; ++c, ++g) {
    const int slot = g & 1;
    mbar_wait(full + slot, (g >> 1) & 1);
    const unsigned char* B = ring + slot * kChunk + wg * 128 * 16;
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // 32 bytes of K: A's pieces 8c + 2s and 8c + 2s + 1, the chunk's 2s and 2s + 1
      const uint64_t da = wg_desc(A + (size_t)(8 * c + 2 * s) * stride, stride, 128);
      const uint64_t db = wg_desc(B + s * 2 * kCS * 16, kCS * 16, 128);
      if constexpr (I8)
        wgmma_s8(d, da, db, c | s);
      else
        wgmma_bf16(d, da, db, c | s);
    }
    wg_commit();
    wg_wait0();
    clk.sync(stage);  // both warpgroups are done with the slot
    if (tid == 0 && (ahead || c + 2 < nchunks)) issue(g + 2);
  }
  store_sums<I8>(d, rsc, X, rows, tid);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return bf2f(v); }

// Keys of one candidate's row scores; lane l holds codewords l, l + 32,
// ..., l + 224.  v2: S[j] = (base + shared[j]) + 2 cross[j] with shared the
// Gmod row (bf16 values, held in bf16 or f32); v1: S[j] = (base + csq[j]) +
// 2 (cross[j] - q[j]) with q the Gram row (`sr`) and csq the codebook's
// squared norms.
template <bool V1, class SR>
__device__ __forceinline__ void row_keys(const float* xr, const SR* sr, const float* csq,
                                         float base, int lane, uint32_t (&keys)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = lane + 32 * q;
    const float s = V1 ? (base + csq[j]) + 2.0f * (xr[j] - to_f32(sr[j]))
                       : (base + to_f32(sr[j])) + 2.0f * xr[j];
    keys[q] = pack_key(s, (uint32_t)j);
  }
}

// The score's per-row constant: v2 (ss - 2 Ec) - ccn with ccn = Gmod[i, i];
// v1 (ss - 2 Ec) + cc with cc = q[i].
template <bool V1>
__device__ __forceinline__ float row_base(float ss, float ec, float si) {
  return V1 ? (ss - 2.0f * ec) + si : (ss - 2.0f * ec) - si;
}

// Byte `byte` of row r of an E buffer: WG, K-chunked (`stride` bytes
// between 16-byte K pieces); else row-major (`stride` bytes a row).
template <bool WG>
__device__ __forceinline__ size_t e_off(int r, int byte, int stride) {
  return WG ? (size_t)(byte >> 4) * stride + (size_t)r * 16 + (byte & 15)
            : (size_t)r * stride + byte;
}

template <int ET>
__device__ __forceinline__ void load_row4(const unsigned char* p, float (&v)[4]) {
  if (ET == kF32) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if (ET == kBF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16); v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16); v[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), v);
  }
}

template <int ET>
__device__ __forceinline__ void store_row4(unsigned char* p, const float (&v)[4]) {
  if (ET == kF32) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 w;
    w.x = pack_bf16x2(v[0], v[1]);
    w.y = pack_bf16x2(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// The 4 bf16 differences c[j, d..d+3] - c[i, d..d+3] of one codebook's rows.
__device__ __forceinline__ void bf16_delta4(const uint16_t* cj, const uint16_t* ci, int d,
                                            float (&dv)[4]) {
  const uint2 wj = *reinterpret_cast<const uint2*>(cj + d);
  const uint2 wi = *reinterpret_cast<const uint2*>(ci + d);
  dv[0] = __uint_as_float(wj.x << 16) - __uint_as_float(wi.x << 16);
  dv[1] = __uint_as_float(wj.x & 0xFFFF0000u) - __uint_as_float(wi.x & 0xFFFF0000u);
  dv[2] = __uint_as_float(wj.y << 16) - __uint_as_float(wi.y << 16);
  dv[3] = __uint_as_float(wj.y & 0xFFFF0000u) - __uint_as_float(wi.y & 0xFFFF0000u);
}

// The 4 int8 differences c8[j, d..d+3] - c8[i, d..d+3], exact in f32.
__device__ __forceinline__ void i8_delta4(const int8_t* cj, const int8_t* ci, int d, float (&dv)[4]) {
  const uint32_t uj = *reinterpret_cast<const uint32_t*>(cj + d) ^ 0x80808080u;
  const uint32_t ui = *reinterpret_cast<const uint32_t*>(ci + d) ^ 0x80808080u;
#pragma unroll
  for (int u = 0; u < 4; ++u) dv[u] = biased_byte(uj, u) - biased_byte(ui, u);  // the biases cancel
}

// One warp extends a candidate row:
//   E_dst[dst_row] = E_src[src_row] + (c_t[j] - c_t[i])
// plus, with LAZY and pj non-null, the deferred delta c_{t-1}[jp] - c_{t-1}[ip].
// cj, ci: the rows of codebook t (int8 after the fan-out with int8 E, else
// bf16), in shared memory (staged) or L2; pj, pi: codebook t-1's, in L2.
// src: the f32 root row (FIRST) or an E buffer; E buffers are addressed by
// e_off<WG> with `stride`.  f32/bf16: in f32, stored in the E type.  int8
// (not first): in csc[t] units, q * (s / csc) + (c8[j] - c8[i]) [+ (c8'[jp] -
// c8'[ip]) * (csc' / csc)], requantized by the REQ rule, scale s_new * csc
// stored; kPass adds round((c8[j] - c8[i]) * (csc / s)) to q and keeps s.
// first: int8 quantizes the absolute f32 sum (scale from the extended row, or
// from the root for kPass).
template <int ET, bool FIRST, int REQ, bool LAZY, bool WG, int MAXC>
__device__ __forceinline__ void extend_row(const Args& a, int D, int t, const void* cj, const void* ci,
                           const void* pj, const void* pi, const unsigned char* src, int src_row,
                           unsigned char* dst, int dst_row, int stride, float src_scale,
                           float* dst_scale, float csc_t, int lane) {
  constexpr bool I8 = ET == kI8 && !FIRST;
  constexpr int ES = ET == kF32 ? 4 : (ET == kBF16 ? 2 : 1);
  const bool prev = LAZY && pj != nullptr;
  const int nchunk = D / 128;
  float ef[MAXC][4];
  float sadj = 0.0f, rprev = 0.0f, col = 0.0f, vmax = 0.0f;
  if (I8) {
    const float inv_csc = 1.0f / csc_t;
    sadj = src_scale * inv_csc;
    if (prev) rprev = a.csc[t - 1] * inv_csc;
    if (REQ == kPass) col = csc_t * (1.0f / src_scale);
  }
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    if (k < nchunk) {
      const int d = 4 * (lane + 32 * k);
      float v[4], dv[4];
      if (FIRST) {
        const float4 w = *reinterpret_cast<const float4*>(src + (size_t)d * 4);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
        load_row4<ET>(src + e_off<WG>(src_row, d * ES, stride), v);
      }
      if (I8) {
        i8_delta4((const int8_t*)cj, (const int8_t*)ci, d, dv);
        if (REQ == kPass) {
#pragma unroll
          for (int u = 0; u < 4; ++u) ef[k][u] = v[u] + round_even(dv[u] * col);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) ef[k][u] = v[u] * sadj + dv[u];
          if (prev) {
            float pv[4];
            i8_delta4((const int8_t*)pj, (const int8_t*)pi, d, pv);
#pragma unroll
            for (int u = 0; u < 4; ++u) ef[k][u] = ef[k][u] + pv[u] * rprev;
          }
        }
      } else {
        bf16_delta4((const uint16_t*)cj, (const uint16_t*)ci, d, dv);
        if (prev) {
          float pv[4];
          bf16_delta4((const uint16_t*)pj, (const uint16_t*)pi, d, pv);
#pragma unroll
          for (int u = 0; u < 4; ++u) dv[u] = dv[u] + pv[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) ef[k][u] = v[u] + dv[u];
        if (FIRST && ET == kI8 && REQ == kPass)
#pragma unroll
          for (int u = 0; u < 4; ++u) vmax = fmaxf(vmax, fabsf(v[u]));
      }
      if (ET != kI8) store_row4<ET>(dst + e_off<WG>(dst_row, d * ES, stride), ef[k]);
    }
  }
  if (ET != kI8) return;
  // kPass after the fan-out: the scale is frozen for the pass and ef already
  // holds the new q; else the row's new scale (step: its max; bound: the
  // parent's grown by cmax_t / 127; kPass at the fan-out: the root's)
  const bool frozen = !FIRST && REQ == kPass;
  float s = src_scale, inv = 1.0f;
  if (!frozen) {
    float amax = vmax;  // kPass, first: the root error's
    if (!(FIRST && REQ == kPass)) {
#pragma unroll
      for (int k = 0; k < MAXC; ++k)
        if (k < nchunk)
#pragma unroll
          for (int u = 0; u < 4; ++u) amax = fmaxf(amax, fabsf(ef[k][u]));
    }
    amax = warp_max(amax);
    s = (!FIRST && REQ == kBound) ? sadj + a.cmax[t] * kInv127 : fmaxf(amax * kInv127, 1e-20f);
    inv = 1.0f / s;
  }
  // round half to even, clipped but for step requant, which never leaves
  // [-127, 127]: its scale is the row's max
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    if (k < nchunk) {
      const int d = 4 * (lane + 32 * k);
      // clipping at the integers +-127 commutes with the rounding
      uint32_t q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x = frozen ? ef[k][u] : ef[k][u] * inv;
        q[u] = round_even_bits(REQ == kStep ? x : clip127(x));
      }
      *reinterpret_cast<uint32_t*>(dst + e_off<WG>(dst_row, d, stride)) =
          low_bytes4(q[0], q[1], q[2], q[3]);
    }
  }
  if (lane == 0) *dst_scale = (FIRST || REQ == kPass) ? s : s * csc_t;
}

// V1: the v1 kernel (f32 E, every step a pool step, v1's score and pool
// packing); it reads qg/csq in place of gmod.  REQ: the int8 requant rule
// (kStep otherwise).  LAZY: lazy_r1 (v2, kStep).  TIMED: the stage-timed
// build, which adds its clock64() sums to a.stages.  SPILL: the spill
// layout (spills(ET, M) only).  MAXC: the extension's chunks of 128 (D <=
// 128 MAXC; kWideChunks for the wide instantiations, whose layouts do not
// stage the fan-out's rows).  bf16 and int8 E take the wgmma design (WG),
// f32 E the mma.sync one (see the top of the file).
template <int ET, int M, bool V1, int REQ, bool LAZY, bool TIMED, bool SPILL, int MAXC>
__global__ void __launch_bounds__(kThreads, 1) seqbeam_kernel(const Args a) {
  constexpr bool WG = ET != kF32;
  constexpr bool RG = !WG && !SPILL;  // f32 E on its ring
  constexpr int ES = ET == kF32 ? 4 : (ET == kBF16 ? 2 : 1);
  static_assert(!SPILL || spills(ET, M), "a beam that never spills");
  extern __shared__ __align__(16) unsigned char smem[];
  StageClock<TIMED> clk;
  clk.start();
  const int F = a.F, D = a.D, nc = a.nc, R = a.R;
  // only the beams of compacts() ever take the compact layout, so the
  // others compile to the full one alone
  const int kind = SPILL ? kSpill : (compacts(ET, M) ? a.kind : kFull);
  const Layout L = make_layout(ET, M, F, D, nc, R, LAZY, kind, MAXC > kNarrowChunks);
  const bool stg = L.stage;  // the extensions' codeword rows are staged
  const int RW = L.rows, mtiles = L.xrows / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fb = blockIdx.x * F;

  // spill: claim a free scratch slot (a resident block holds one at most,
  // and frees it at its end)
  unsigned char* eslot = nullptr;
  if (SPILL) {
    int* cell = reinterpret_cast<int*>(smem + L.slot);
    if (tid == 0) {
      int s = blockIdx.x % a.nslots;
      while (atomicCAS(a.slots + s, 0, 1) != 0) s = (s + 1) % a.nslots;
      *cell = s;
    }
    __syncthreads();
    eslot = a.spill + (size_t)*cell * L.spill_bytes;
  }
  // the double buffers by index (an array of pointers would sit in local
  // memory and make their accesses generic rather than shared).  spill:
  // wgmma's rows stay in E[0] (a pool step extends from the copy in the
  // slot); f32 E's two buffers lie in the slot
  auto Eb = [&](int i) -> unsigned char* {
    if (SPILL) return WG ? smem + L.e0 : eslot + (i ? L.spill_bytes / 2 : 0);
    return smem + (i ? L.e1 : L.e0);
  };
  float* Er = reinterpret_cast<float*>(smem + L.er);
  float* X = reinterpret_cast<float*>(smem + L.xs);
  float* srow = reinterpret_cast<float*>(smem + L.srow);        // f32 E (RG: buffer t & 1)
  uint16_t* srow2 = reinterpret_cast<uint16_t*>(smem + L.srow);  // WG: bf16, buffer t & 1
  auto scb = [&](int i) { return reinterpret_cast<float*>(smem + (i ? L.sc1 : L.sc0)); };
  float* rsc = reinterpret_cast<float*>(smem + L.rsc);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  float* ss0 = reinterpret_cast<float*>(smem + L.ss0);
  auto chb = [&](int i) { return reinterpret_cast<int*>(smem + (i ? L.ch1 : L.ch0)); };
  int* sol = reinterpret_cast<int*>(smem + L.sol);
  int* selj = reinterpret_cast<int*>(smem + L.selj);
  int* selp = reinterpret_cast<int*>(smem + L.selp);
  int* jdef = reinterpret_cast<int*>(smem + L.jdef);
  uint32_t* rkeys = reinterpret_cast<uint32_t*>(smem + L.rkeys);
  unsigned char* ring = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned char* cst = smem + L.xs;  // the extension's staged codeword rows (X's space)
  // bytes of a row of the codebook whose deltas the steps' extensions add:
  // int8 with int8 E, else bf16
  const int crb = ET == kI8 ? D : 2 * D;

  // f32 E, spill: the per-frame score row of codebook t, v2 Gmod_t[sol_t, :],
  // v1 q_t[sol_t, :]
  auto load_srow = [&](int t) {
    for (int i = tid; i < F * kCS; i += kThreads) {
      const int f = i / kCS;
      const size_t at = ((size_t)t * kCS + sol[f * nc + t]) * kCS + (i % kCS);
      srow[i] = V1 ? a.qg[at] : bf2f(a.gmod[at]);
    }
  };
  // WG: the same rows of Gmod as bf16 by cp.async into buffer t & 1 (waited
  // for by the next cp_async_wait_all)
  auto fetch_srow = [&](int t) {
    for (int i = tid; i < F * 32; i += kThreads) {
      const int f = i >> 5, piece = i & 31;
      cp_async16(srow2 + ((t & 1) * F + f) * kCS + piece * 8,
                 a.gmod + ((size_t)t * kCS + sol[f * nc + t]) * kCS + piece * 8);
    }
    cp_async_commit();
  };
  // RG: the rows of load_srow by cp.async into buffer t & 1 (F + 1 rows of
  // 256 floats), v2's bf16 rows in the first half of their f32 rows, and
  // v1's |c_t|^2 as row F
  auto srow_f = [&](int t, int f) { return srow + ((t & 1) * (F + 1) + f) * kCS; };
  auto fetch_srow_f = [&](int t) {
    constexpr int pieces = V1 ? 64 : 32;  // 16-byte pieces a row
    for (int i = tid; i < (V1 ? F + 1 : F) * pieces; i += kThreads) {
      const int f = i / pieces, piece = i % pieces;
      const void* src;
      if (!V1)
        src = a.gmod + ((size_t)t * kCS + sol[f * nc + t]) * kCS + piece * 8;
      else if (f < F)
        src = a.qg + ((size_t)t * kCS + sol[f * nc + t]) * kCS + piece * 4;
      else
        src = a.csq + (size_t)t * kCS + piece * 4;
      cp_async16(reinterpret_cast<unsigned char*>(srow_f(t, f)) + piece * 16, src);
    }
    cp_async_commit();
  };
  // RG: the ring's sequence, per pass the D / 64 bf16 chunks of each
  // codebook in order; thread 0 loads chunk s into slot s % S (S divides D /
  // 64), slot 0 at L.ring, slot 1 at the start of X's space
  const int nf = D / kKF, per_pass_f = nc * nf, total_f = a.passes * per_pass_f;
  auto slot_f = [&](int k) { return k == 0 ? ring : smem + L.xs; };
  const int S = L.slots;
  int g = 0;  // WG, RG: ring chunks consumed
  auto issue_f = [&](int s) {
    if (s >= total_f) return;
    bulk_load(slot_f(s % S), a.cpb + (size_t)(s % per_pass_f) * kChunk, kChunk,
              full + s % S);
  };
  // RG: the next rescore's chunk 0, once X is read, and (full layout)
  // chunk 1, once the staged rows are read; the caller fences and syncs
  // first
  auto issue_first = [&]() {
    if (RG && tid == 0) issue_f(g);
  };
  auto issue_second = [&]() {
    if (RG && tid == 0 && S > 1) issue_f(g + 1);
  };
  // WG: the ring's sequence, per pass the root's bf16 chunks of codebook 0,
  // then the E-type chunks of codebooks 1 .. nc-1; thread 0 loads chunk s
  // into slot s & 1
  const int nr = 2 * D / 128, ns = D * ES / 128;
  const int per_pass = nr + (nc - 1) * ns, total = a.passes * per_pass;
  auto issue = [&](int s) {
    if (s >= total) return;
    const int r = s % per_pass;
    const unsigned char* src =
        r < nr ? a.cpb + (size_t)r * kChunk
               : (ET == kI8 ? a.cpi : a.cpb) +
                     ((size_t)(1 + (r - nr) / ns) * ns + (r - nr) % ns) * kChunk;
    bulk_load(ring + (s & 1) * kChunk, src, kChunk, full + (s & 1));
  };

  if ((WG || RG) && tid == 0)
    for (int k = 0; k < 2; ++k) mbar_init(full + k);
  for (int i = tid; i < F * nc; i += kThreads) {
    const int b = fb + i / nc;
    sol[i] = b < a.B ? a.idx0[(size_t)b * nc + i % nc] : 0;
  }
  clk.sync(kStRoot);
  if (WG && L.ahead && tid == 0) {
    issue(0);
    issue(1);
  }
  issue_first();
  issue_second();

  for (int p = 0; p < a.passes; ++p) {
    // the fan-out's and step 1's score rows load while the root is summed
    if constexpr (WG) {
      fetch_srow(0);
      fetch_srow(1);
    } else if constexpr (RG) {
      fetch_srow_f(0);
      fetch_srow_f(1);
    }
    // ---- root: E = -x + sum_s bf16(C_s[sol_s]) in f32, codebook order; 8
    // consecutive values a thread, every codebook's row loaded at once.  WG:
    // also the bf16 A operand of the root's rescore, K-chunked, in E[1]
    for (int i = tid; i < F * D / 8; i += kThreads) {
      const int f = i / (D / 8), d = 8 * (i - f * (D / 8));
      const int b = fb + f;
      float e[8];
      if (b < a.B) {
        const float4 x0 = *reinterpret_cast<const float4*>(a.x + (size_t)b * D + d);
        const float4 x1 = *reinterpret_cast<const float4*>(a.x + (size_t)b * D + d + 4);
        e[0] = -x0.x; e[1] = -x0.y; e[2] = -x0.z; e[3] = -x0.w;
        e[4] = -x1.x; e[5] = -x1.y; e[6] = -x1.z; e[7] = -x1.w;
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = 0.0f;
      }
      uint4 c[kMaxNc];
#pragma unroll
      for (int s = 0; s < kMaxNc; ++s)
        if (s < nc)
          c[s] = *reinterpret_cast<const uint4*>(a.C + ((size_t)s * kCS + sol[f * nc + s]) * D + d);
#pragma unroll
      for (int s = 0; s < kMaxNc; ++s) {
        if (s < nc) {
          const uint32_t w[4] = {c[s].x, c[s].y, c[s].z, c[s].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            e[2 * u] = e[2 * u] + __uint_as_float(w[u] << 16);
            e[2 * u + 1] = e[2 * u + 1] + __uint_as_float(w[u] & 0xFFFF0000u);
          }
        }
      }
      float* er = Er + f * L.er_stride + d;
      *reinterpret_cast<float4*>(er) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<float4*>(er + 4) = make_float4(e[4], e[5], e[6], e[7]);
      if (WG)
        *reinterpret_cast<uint4*>(smem + L.e1 + (size_t)(d / 8) * L.root_stride + f * 16) =
            make_uint4(pack_bf16x2(e[0], e[1]), pack_bf16x2(e[2], e[3]), pack_bf16x2(e[4], e[5]),
                       pack_bf16x2(e[6], e[7]));
    }
    if (WG) fence_proxy_async();
    clk.lap(kStRoot);
    if constexpr (WG || RG)
      cp_async_wait_all();
    else
      load_srow(0);
    clk.sync(kStSrow);
    for (int f = warp; f < F; f += kWarps) {
      float acc = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float v = Er[f * L.er_stride + d];
        acc = acc + v * v;
      }
      acc = warp_sum(acc);
      if (lane == 0) ss0[f] = acc;
    }
    // ---- step 0: rescore the root only, fan out to the M best
    if constexpr (WG)
      wg_rescore<false>(smem + L.e1, L.root_stride, nr, ring, full, g, L.ahead, issue, rsc, X, F,
                        clk, kStRoot, tid);
    else if constexpr (RG)
      wg_rescore_f32(reinterpret_cast<const unsigned char*>(Er), L.er_stride * 4, F, nf, S,
                     slot_f, full, g, issue_f, X, clk, kStRoot, tid);
    else
      rescore_bf16(reinterpret_cast<const unsigned char*>(Er), L.er_stride * 4, F, 1, a.C, D, X,
                   warp, lane);
    clk.sync(kStRoot);
    for (int f = warp; f < F; f += kWarps) {
      const int i0 = sol[f * nc];
      const float* xr = X + f * kXS;
      uint32_t keys[8];
      if constexpr (WG) {
        const uint16_t* sr = srow2 + f * kCS;
        row_keys<V1>(xr, sr, a.csq, row_base<V1>(ss0[f], xr[i0], bf2f(sr[i0])), lane, keys);
      } else if constexpr (RG && V1) {
        const float* sr = srow_f(0, f);
        row_keys<V1>(xr, sr, srow_f(0, F), row_base<V1>(ss0[f], xr[i0], sr[i0]), lane, keys);
      } else if constexpr (RG) {
        const uint16_t* sr = reinterpret_cast<const uint16_t*>(srow_f(0, f));
        row_keys<V1>(xr, sr, a.csq, row_base<V1>(ss0[f], xr[i0], bf2f(sr[i0])), lane, keys);
      } else {
        const float* sr = srow + f * kCS;
        row_keys<V1>(xr, sr, a.csq, row_base<V1>(ss0[f], xr[i0], sr[i0]), lane, keys);
      }
      sort8(keys);
      for (int m = 0; m < M; ++m) {
        const uint32_t w = pop_min(keys);
        if (lane == 0) {
          selj[f * M + m] = (int)(w & kLaneMask);
          ss[f * M + m] = __uint_as_float(w & ~kLaneMask);
        }
      }
    }
    if (RG) fence_proxy_async();  // X is read: step 1's first chunks may land there
    clk.sync(kStRoot);
    issue_first();
    for (int i = tid; i < RW * nc; i += kThreads) {
      const int r = i / nc, s = i - r * nc;
      chb(0)[i] = s == 0 ? selj[r] : sol[(r / M) * nc + s];
    }
    // the fan-out's C_0[i] of every frame: WG (int8 E has no room for it in
    // X's space) in E[1], where the root's A rows are spent; f32 E after
    // the rows' C_0[j]
    unsigned char* ci0 = WG ? Eb(1) : cst + (size_t)RW * 2 * D;
    if (L.fan) {
      // stage the bf16 rows C_0[j] of every row into X's space, and C_0[i]
      const int pieces = 2 * D / 16;
      for (int i = tid; i < (RW + F) * pieces; i += kThreads) {
        const int row = i / pieces, off = (i - row * pieces) * 16;
        unsigned char* to =
            row < RW ? cst + (size_t)row * 2 * D : ci0 + (size_t)(row - RW) * 2 * D;
        const int j = row < RW ? selj[row] : sol[(row - RW) * nc];
        cp_async16(to + off, reinterpret_cast<const unsigned char*>(a.C + (size_t)j * D) + off);
      }
      cp_async_commit();
      cp_async_wait_all();
      clk.sync(kStRoot);
    }
    // one call for staged rows, one for L2's: a pointer that could be either
    // would make every access of the extension a generic one
    for (int r = warp; r < RW; r += kWarps) {
      const int f = r / M;
      const unsigned char* er = reinterpret_cast<const unsigned char*>(Er + f * L.er_stride);
      const float csc0 = ET == kI8 ? a.csc[0] : 1.0f;
      if (L.fan)
        extend_row<ET, true, REQ, LAZY, WG, MAXC>(
            a, D, 0, cst + (size_t)r * 2 * D, ci0 + (size_t)f * 2 * D, nullptr, nullptr, er, 0,
            Eb(0), r, L.e_stride, 0.0f, scb(0) + r, csc0, lane);
      else
        extend_row<ET, true, REQ, LAZY, WG, MAXC>(
            a, D, 0, a.C + (size_t)selj[r] * D, a.C + (size_t)sol[f * nc] * D, nullptr, nullptr,
            er, 0, Eb(0), r, L.e_stride, 0.0f, scb(0) + r, csc0, lane);
    }
    if (WG || RG) fence_proxy_async();
    clk.sync(kStRoot);
    issue_second();

    int cur = 0;
    bool pend = false;  // lazy_r1: step t-1 deferred its E update (jdef)
    for (int t = 1; t < nc; ++t) {
      const bool pool = V1 || ((a.pool[p] >> t) & 1u);
      const bool last = t == nc - 1;
      const bool defer = LAZY && !pool && !last;
      const float csc_t = ET == kI8 ? a.csc[t] : 1.0f;
      if constexpr (WG) {
        if (t + 1 < nc) fetch_srow(t + 1);
      } else if constexpr (RG) {
        if (t + 1 < nc) fetch_srow_f(t + 1);
      } else {
        load_srow(t);
      }
      clk.lap(kStSrow);
      if (ET == kI8)
        for (int r = tid; r < RW; r += kThreads) rsc[r] = scb(cur)[r] * csc_t;
      // ---- rescore all candidates against codebook t
      if constexpr (WG) {
        // rsc is read after the rescore's first barrier
        wg_rescore<ET == kI8>(Eb(cur), L.e_stride, ns, ring, full, g, L.ahead, issue, rsc, X, RW,
                              clk, kStRescore, tid);
      } else if constexpr (RG) {
        wg_rescore_f32(Eb(cur), L.e_stride, RW, nf, S, slot_f, full, g, issue_f, X, clk,
                       kStRescore, tid);
      } else {
        clk.sync(kStRescore);
        rescore_bf16(Eb(cur), L.e_stride, RW, mtiles, a.C + (size_t)t * kCS * D, D, X, warp, lane);
      }
      clk.sync(kStRescore);
      // ---- score assembly and per-row selection
      for (int r = warp; r < RW; r += kWarps) {
        const int f = r / M;
        const int it = sol[f * nc + t];
        float* xr = X + r * kXS;
        if (LAZY && pend) {
          // the row still lacks codebook t-1's deferred delta: correct its
          // cross by Gx_t[j'] - Gx_t[i'] (bf16 values, f32 difference)
          const uint16_t* gj = a.gx + ((size_t)t * kCS + jdef[r]) * kCS;
          const uint16_t* gi = a.gx + ((size_t)t * kCS + sol[f * nc + t - 1]) * kCS;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = lane + 32 * q;
            xr[j] = xr[j] + (bf2f(gj[j]) - bf2f(gi[j]));
          }
          __syncwarp();
        }
        uint32_t keys[8];
        if constexpr (WG) {
          const uint16_t* sr = srow2 + ((t & 1) * F + f) * kCS;
          row_keys<V1>(xr, sr, a.csq + (size_t)t * kCS,
                       row_base<V1>(ss[r], xr[it], bf2f(sr[it])), lane, keys);
        } else if constexpr (RG && V1) {
          const float* sr = srow_f(t, f);
          row_keys<V1>(xr, sr, srow_f(t, F), row_base<V1>(ss[r], xr[it], sr[it]), lane, keys);
        } else if constexpr (RG) {
          const uint16_t* sr = reinterpret_cast<const uint16_t*>(srow_f(t, f));
          row_keys<V1>(xr, sr, a.csq, row_base<V1>(ss[r], xr[it], bf2f(sr[it])), lane, keys);
        } else {
          const float* sr = srow + f * kCS;
          row_keys<V1>(xr, sr, a.csq + (size_t)t * kCS, row_base<V1>(ss[r], xr[it], sr[it]), lane,
                       keys);
        }
        if (!pool) {
          // R1: each parent keeps its best child in place
          const uint32_t w = warp_min(keys);
          if (lane == 0) {
            selj[r] = (int)(w & kLaneMask);
            selp[r] = r - f * M;
            ss[r] = __uint_as_float(w & ~kLaneMask);
            chb(cur)[r * nc + t] = (int)(w & kLaneMask);
            if (defer) jdef[r] = (int)(w & kLaneMask);
          }
        } else {
          sort8(keys);
          for (int k = 0; k < R; ++k) {
            const uint32_t w = pop_min(keys);
            if (lane == 0) rkeys[r * R + k] = w;
          }
        }
      }
      if (RG) fence_proxy_async();  // X is read: the next rescore's first chunks may land there
      clk.sync(kStSelect);
      issue_first();
      if (pool) {
        // ---- top-M of each frame's M*R pool: every entry counts its
        // frame's smaller keys, all warps at once; the keys are distinct, so
        // the entry of rank n < M is the frame's n-th best.  v2: the parent id
        // above the lane bits; v1: the pool lane m*R + r in the lane bits
        const uint32_t mbits = (uint32_t)(M - 1) << 8;
        const int P = M * R;
        for (int i = tid; i < F * P; i += kThreads) {
          const int f = i / P, e = i - f * P;
          const uint32_t* fk = rkeys + f * P;
          auto pack = [&](uint32_t k, int q, int par) {
            return V1 ? (k & ~kLaneMask) | (uint32_t)q : (k & ~mbits) | ((uint32_t)par << 8);
          };
          const uint32_t w = pack(fk[e], e, e / R);
          int rank = 0;
          for (int q = 0, par = 0, kk = 0; q < P; q += 4) {
            const uint4 k4 = *reinterpret_cast<const uint4*>(fk + q);
            const uint32_t kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              rank += pack(kv[u], q + u, par) < w;
              if (++kk == R) {
                kk = 0;
                ++par;
              }
            }
          }
          if (rank < M) {
            const int n = f * M + rank;
            selj[n] = (int)((V1 ? fk[e] : w) & kLaneMask);
            selp[n] = e / R;
            ss[n] = __uint_as_float(w & ~((V1 ? 0u : mbits) | kLaneMask));
          }
        }
        clk.sync(kStPool);
      }
      // ---- extension (none on the last step of a pass, or a deferring R1
      // step).  Staged: C_t[j] of every row, then C_t[i] of every frame
      // (X is free), the copies landing while the beam is reordered
      const bool extend = !last && !defer;
      const unsigned char* ct =
          ET == kI8 ? reinterpret_cast<const unsigned char*>(a.C8 + (size_t)t * kCS * D)
                    : reinterpret_cast<const unsigned char*>(a.C + (size_t)t * kCS * D);
      if (stg && extend) {
        const int pieces = crb / 16;
        for (int i = tid; i < (RW + F) * pieces; i += kThreads) {
          const int row = i / pieces, off = (i - row * pieces) * 16;
          const int j = row < RW ? selj[row] : sol[(row - RW) * nc + t];
          cp_async16(cst + (size_t)row * crb + off, ct + (size_t)j * crb + off);
        }
        cp_async_commit();
      }
      if (pool) {
        for (int i = tid; i < RW * nc; i += kThreads) {
          const int r = i / nc, s = i - r * nc;
          const int f = r / M;
          chb(cur ^ 1)[i] = s == t ? selj[r] : chb(cur)[(f * M + selp[r]) * nc + s];
        }
        clk.lap(kStReorder);
      }
      // spill (wgmma): the parents' rows go to the slot, and the children
      // are extended from there into E[0]
      const bool from_slot = SPILL && WG && pool;
      if (extend) {
        const int dst = pool ? cur ^ 1 : cur;
        if (stg) {
          cp_async_wait_all();
          clk.sync(kStExtend);
        }
        if (from_slot) {
          const uint4* from = reinterpret_cast<const uint4*>(smem + L.e0);
          for (size_t i = tid; i < L.spill_bytes / 16; i += kThreads)
            reinterpret_cast<uint4*>(eslot)[i] = from[i];
          clk.sync(kStReorder);
        }
        for (int r = warp; r < RW; r += kWarps) {
          const int f = r / M;
          const int src_row = f * M + selp[r];
          const int it = sol[f * nc + t];
          const void *pj = nullptr, *pi = nullptr;
          if (LAZY && pend) {
            const unsigned char* cp =
                ET == kI8 ? reinterpret_cast<const unsigned char*>(a.C8 + (size_t)(t - 1) * kCS * D)
                          : reinterpret_cast<const unsigned char*>(a.C + (size_t)(t - 1) * kCS * D);
            pj = cp + (size_t)jdef[src_row] * crb;
            pi = cp + (size_t)sol[f * nc + t - 1] * crb;
          }
          const float s_src = ET == kI8 ? scb(cur)[src_row] : 0.0f;
          if (stg)
            extend_row<ET, false, REQ, LAZY, WG, MAXC>(
                a, D, t, cst + (size_t)r * crb, cst + (size_t)(RW + f) * crb, pj, pi, Eb(cur),
                src_row, Eb(dst), r, L.e_stride, s_src, scb(dst) + r, csc_t, lane);
          else if (from_slot)
            extend_row<ET, false, REQ, LAZY, WG, MAXC>(
                a, D, t, ct + (size_t)selj[r] * crb, ct + (size_t)it * crb, pj, pi, eslot,
                src_row, Eb(dst), r, L.e_stride, s_src, scb(dst) + r, csc_t, lane);
          else
            extend_row<ET, false, REQ, LAZY, WG, MAXC>(
                a, D, t, ct + (size_t)selj[r] * crb, ct + (size_t)it * crb, pj, pi, Eb(cur),
                src_row, Eb(dst), r, L.e_stride, s_src, scb(dst) + r, csc_t, lane);
        }
      }
      // WG: E's new rows are read by the next wgmma, and without `ahead`
      // the ring's next copies land in X's space; RG: the next rescore's
      // chunk 1 lands in slot 1, on the staged rows, once they are read
      if ((WG && (extend || !L.ahead)) || RG) fence_proxy_async();
      if (WG || RG) cp_async_wait_all();  // the next step's score rows
      if (pool) cur ^= 1;
      pend = defer;
      clk.sync(kStExtend);
      issue_second();
    }
    // ---- pass end: the best candidate by packed (ss, m) becomes the root
    for (int f = warp; f < F; f += kWarps) {
      uint32_t k = kNone;
      for (int m = lane; m < M; m += 32) k = min(k, pack_key(ss[f * M + m], (uint32_t)m));
      const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, k);
      const int best = (int)(w & kLaneMask);
      if (lane < nc) sol[f * nc + lane] = chb(cur)[(f * M + best) * nc + lane];
    }
    clk.sync(kStRoot);
  }
  for (int i = tid; i < F * nc; i += kThreads) {
    const int b = fb + i / nc;
    if (b < a.B) a.out[(size_t)b * nc + i % nc] = sol[i];
  }
  if (SPILL) {
    // every write to the slot is done before the next block may claim it
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(a.slots + *reinterpret_cast<int*>(smem + L.slot), 0);
  }
  clk.lap(kStRoot);
  clk.finish(a.stages + (size_t)blockIdx.x * kStageCols, tid);
}

template <int ET, int M, bool V1, int REQ, bool LAZY, bool TIMED, bool SPILL, int MAXC>
int launch_kernel(const Args& a, size_t smem, cudaStream_t stream) {
  auto* k = seqbeam_kernel<ET, M, V1, REQ, LAZY, TIMED, SPILL, MAXC>;
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.B + a.F - 1) / a.F);
  if (blocks > 0) k<<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel of a.kind's layout: the spill one's, or the other layouts'.
template <int ET, int M, bool V1, int REQ, bool LAZY, bool TIMED = false>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  if constexpr (spills(ET, M))
    if (a.kind == kSpill)
      return launch_kernel<ET, M, V1, REQ, LAZY, TIMED, true, kNarrowChunks>(a, smem, stream);
  return launch_kernel<ET, M, V1, REQ, LAZY, TIMED, false, kNarrowChunks>(a, smem, stream);
}

// Beams the wide instantiations take (D > 1024): auto's two rungs, v2 with
// bf16 or int8 E, M=8, requant "step", no lazy_r1.
__host__ __device__ constexpr bool wide_beam(int et, int M, bool lazy) {
  return et != kF32 && M == 8 && !lazy;
}

// A wide beam (D in (1024, 1280]) in its wide instantiation.
template <bool TIMED = false>
int launch_wide(const Args& a, int e_dtype, size_t smem, cudaStream_t st) {
  if (e_dtype == kI8)
    return launch_kernel<kI8, 8, false, kStep, false, TIMED, false, kWideChunks>(a, smem, st);
  return launch_kernel<kBF16, 8, false, kStep, false, TIMED, false, kWideChunks>(a, smem, st);
}

template <int ET, int REQ, bool LAZY>
int launch_m(const Args& a, int M, size_t smem, cudaStream_t stream) {
  switch (M) {
    case 8: return launch<ET, 8, false, REQ, LAZY>(a, smem, stream);
    case 16: return launch<ET, 16, false, REQ, LAZY>(a, smem, stream);
    case 32: return launch<ET, 32, false, REQ, LAZY>(a, smem, stream);
    case 64: return launch<ET, 64, false, REQ, LAZY>(a, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The valid (e_dtype, requant, lazy) variants: "pass" and "bound" are int8
// only, lazy_r1 takes "step" only.
int launch_v2(const Args& a, int e_dtype, int M, int requant, bool lazy, size_t smem,
              cudaStream_t s) {
  if (a.D > kNarrowDim)
    return wide_beam(e_dtype, M, lazy) && requant == kStep ? launch_wide(a, e_dtype, smem, s)
                                                           : (int)cudaErrorInvalidValue;
  if (lazy) {
    switch (e_dtype) {
      case kF32: return launch_m<kF32, kStep, true>(a, M, smem, s);
      case kBF16: return launch_m<kBF16, kStep, true>(a, M, smem, s);
      case kI8: return launch_m<kI8, kStep, true>(a, M, smem, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (e_dtype == kI8 && requant == kPass) return launch_m<kI8, kPass, false>(a, M, smem, s);
  if (e_dtype == kI8 && requant == kBound) return launch_m<kI8, kBound, false>(a, M, smem, s);
  switch (e_dtype) {
    case kF32: return launch_m<kF32, kStep, false>(a, M, smem, s);
    case kBF16: return launch_m<kBF16, kStep, false>(a, M, smem, s);
    case kI8: return launch_m<kI8, kStep, false>(a, M, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_v1(const Args& a, int M, size_t smem, cudaStream_t stream) {
  switch (M) {
    case 8: return launch<kF32, 8, true, kStep, false>(a, smem, stream);
    case 16: return launch<kF32, 16, true, kStep, false>(a, smem, stream);
    case 24: return launch<kF32, 24, true, kStep, false>(a, smem, stream);
    case 32: return launch<kF32, 32, true, kStep, false>(a, smem, stream);
    case 40: return launch<kF32, 40, true, kStep, false>(a, smem, stream);
    case 48: return launch<kF32, 48, true, kStep, false>(a, smem, stream);
    case 56: return launch<kF32, 56, true, kStep, false>(a, smem, stream);
    case 64: return launch<kF32, 64, true, kStep, false>(a, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Frames per block for a configuration and its layout (`*kind`): the most
// F (F * M <= 64 candidate rows, at least 16) whose shared memory fits, in
// the full layout if any F fits it, else (bf16 and int8 E with M >= 32, f32
// E with spills()) in the compact one, else (spills(): f32 E from M = 24,
// wgmma's M = 64) in the spill one; 0 if none does.  Every beam narrower
// than 24 fits the full layout up to D = 1024.  Above it only wide_beam()s
// run, up to D = 1280, in the full layout without the fan-out's staged
// rows (int8 E: F = 4; bf16 E: F = 2).
int frames_per_block(int e_dtype, int M, int D, int nc, int R, bool lazy, int* kind) {
  const bool wide = D > kNarrowDim;
  if (D > kWideDim || (wide && !wide_beam(e_dtype, M, lazy))) return 0;
  for (int k = kFull; k <= kSpill; ++k) {
    if ((k == kCompact && !compacts(e_dtype, M)) || (k == kSpill && !spills(e_dtype, M)))
      continue;
    for (int F = kMaxRows / M; F >= 1 && F * M >= 16; F /= 2)
      if (make_layout(e_dtype, M, F, D, nc, R, lazy, k, wide).total <= kMaxSmem) {
        *kind = k;
        return F;
      }
  }
  return 0;
}

Args make_args(const void* x, const void* idx0, const void* centers, void* out, int B, int D,
               int nc, int R, int passes, void* spill, void* slots, int nslots) {
  Args a = {};
  a.x = (const float*)x;
  a.idx0 = (const int32_t*)idx0;
  a.C = (const uint16_t*)centers;
  a.out = (int32_t*)out;
  a.spill = (unsigned char*)spill;
  a.slots = (int*)slots;
  a.B = B; a.D = D; a.nc = nc; a.R = R; a.passes = passes; a.nslots = nslots;
  return a;
}

// The layout of a configuration (see frames_per_block); a spill layout
// needs the caller's scratch slots.
int layout_args(Args* a, int e_dtype, int M, bool lazy, size_t* smem) {
  a->F = frames_per_block(e_dtype, M, a->D, a->nc, a->R, lazy, &a->kind);
  if (a->F == 0) return (int)cudaErrorInvalidValue;
  if (a->kind == kSpill && (!a->spill || !a->slots || a->nslots < 1))
    return (int)cudaErrorInvalidValue;
  const bool wide = a->D > kNarrowDim;
  *smem = make_layout(e_dtype, M, a->F, a->D, a->nc, a->R, lazy, a->kind, wide).total;
  return 0;
}

int v2_args(const void* x, const void* idx0, const void* centers, const void* gmod,
            const void* centers_i8, const void* csc, const void* cmax, const void* gx,
            const void* chunks_bf16, const void* chunks_i8, void* out, int B, int D, int nc, int M,
            int R, int passes, const void* pool_masks, int e_dtype, int requant, int lazy,
            void* spill, void* slots, int nslots, Args* out_args, size_t* smem) {
  if (passes > kMaxPasses || passes < 0 || requant < kStep || requant > kBound)
    return (int)cudaErrorInvalidValue;
  if ((e_dtype == kI8 && !csc) || (requant != kStep && (e_dtype != kI8 || lazy)) ||
      (requant == kBound && !cmax) || (lazy && !gx) || !chunks_bf16 ||
      (e_dtype == kI8 && !chunks_i8))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x, idx0, centers, out, B, D, nc, R, passes, spill, slots, nslots);
  a.cpb = (const unsigned char*)chunks_bf16;
  a.cpi = (const unsigned char*)chunks_i8;
  a.gmod = (const uint16_t*)gmod;
  a.C8 = (const int8_t*)centers_i8;
  a.csc = (const float*)csc;
  a.cmax = (const float*)cmax;
  a.gx = (const uint16_t*)gx;
  for (int p = 0; p < kMaxPasses; ++p) a.pool[p] = p < passes ? ((const uint32_t*)pool_masks)[p] : 0u;
  const int err = layout_args(&a, e_dtype, M, lazy != 0, smem);
  *out_args = a;
  return err;
}

int v1_args(const void* x, const void* idx0, const void* centers, const void* qgram,
            const void* csq, const void* chunks_bf16, void* out, int B, int D, int nc, int M,
            int R, int passes, void* spill, void* slots, int nslots, Args* out_args,
            size_t* smem) {
  if (passes > kMaxPasses || passes < 0 || M * R > kCS || !chunks_bf16)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x, idx0, centers, out, B, D, nc, R, passes, spill, slots, nslots);
  a.cpb = (const unsigned char*)chunks_bf16;
  a.qg = (const float*)qgram;
  a.csq = (const float*)csq;
  const int err = layout_args(&a, kF32, M, false, smem);
  *out_args = a;
  return err;
}

}  // namespace

// x (B, D) f32; idx0 (B, nc) int32; centers (nc * 256, D) bf16; gmod
// (nc * 256, 256) bf16; centers_i8 (nc * 256, D) int8 and csc (nc,) f32 for
// e_dtype 2 (int8), else null; cmax (nc,) f32 for requant 2 ("bound"), else
// null; gx (nc * 256, 256) bf16 for lazy != 0, else null; chunks_bf16:
// centers as the ring's chunks (Args::cpb); chunks_i8: centers_i8 as them
// (Args::cpi) for e_dtype 2, else null; out (B, nc) int32. pool_masks:
// `passes` host words, bit t set where step t is a pool step. e_dtype: 0 f32,
// 1 bf16, 2 int8. requant: 0 step, 1 pass, 2 bound (int8 only). spill, slots,
// nslots: for a spill layout (qtt_seqbeam_layout), nslots scratch slots of its
// spill bytes and nslots zeroed int32 flags, else null, null, 0.  Shapes and
// combinations are checked by the caller: D % 128 == 0, D <= 1280 (above
// 1024 only bf16 or int8 E, M = 8, requant 0, no lazy), nc even and <= 16,
// M in {8, 16, 32, 64}, M * R <= 512; with lazy, no deferring R1 step is
// followed by another R1 step.
extern "C" int qtt_seqbeam_v2_launch(const void* x, const void* idx0, const void* centers,
                                     const void* gmod, const void* centers_i8, const void* csc,
                                     const void* cmax, const void* gx, const void* chunks_bf16,
                                     const void* chunks_i8, void* out, int B, int D, int nc, int M,
                                     int R, int passes, const void* pool_masks, int e_dtype,
                                     int requant, int lazy, void* spill, void* slots, int nslots,
                                     void* stream) {
  Args a;
  size_t smem;
  const int err = v2_args(x, idx0, centers, gmod, centers_i8, csc, cmax, gx, chunks_bf16,
                          chunks_i8, out, B, D, nc, M, R, passes, pool_masks, e_dtype, requant,
                          lazy, spill, slots, nslots, &a, &smem);
  if (err) return err;
  return launch_v2(a, e_dtype, M, requant, lazy != 0, smem, (cudaStream_t)stream);
}

// The stage-timed build of the v2 kernel, for the auto ladder's two rungs
// only (M=8, requant "step", no lazy_r1; bf16 or int8 E): the arguments of
// qtt_seqbeam_v2_launch, then stages, a zeroed (blocks, 10) int64 buffer
// (blocks from the layout's F).  Per block it receives the
// clock64() cycles of each stage summed over the block's 8 warps (root,
// load_srow, rescore, selection, pool, reorder, extension, barrier waits),
// then the block's own cycles and %globaltimer nanoseconds.
extern "C" int qtt_seqbeam_v2_timed_launch(const void* x, const void* idx0, const void* centers,
                                           const void* gmod, const void* centers_i8,
                                           const void* csc, const void* cmax, const void* gx,
                                           const void* chunks_bf16, const void* chunks_i8,
                                           void* out, int B, int D, int nc, int M, int R,
                                           int passes, const void* pool_masks, int e_dtype,
                                           int requant, int lazy, void* spill, void* slots,
                                           int nslots, void* stages, void* stream) {
  if (M != 8 || requant != kStep || lazy || e_dtype == kF32 || !stages)
    return (int)cudaErrorInvalidValue;
  Args a;
  size_t smem;
  const int err = v2_args(x, idx0, centers, gmod, centers_i8, csc, cmax, gx, chunks_bf16,
                          chunks_i8, out, B, D, nc, M, R, passes, pool_masks, e_dtype, requant,
                          lazy, spill, slots, nslots, &a, &smem);
  if (err) return err;
  a.stages = (long long*)stages;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D > kNarrowDim) return launch_wide<true>(a, e_dtype, smem, st);
  return e_dtype == kI8 ? launch<kI8, 8, false, kStep, false, true>(a, smem, st)
                        : launch<kBF16, 8, false, kStep, false, true>(a, smem, st);
}

// The layout of a v2 configuration, or of v1's with e_dtype 0 (f32): out
// receives F (frames a block, 0 if none fits), the kind (0 full, 1 compact,
// 2 spill), the shared memory bytes and the bytes of a spill slot (0 unless
// the layout spills).
extern "C" int qtt_seqbeam_layout(int e_dtype, int M, int D, int nc, int R, int lazy,
                                  void* out) {
  long long* o = (long long*)out;
  int kind = kFull;
  const int F = frames_per_block(e_dtype, M, D, nc, R, lazy != 0, &kind);
  const Layout L =
      make_layout(e_dtype, M, F > 0 ? F : 1, D, nc, R, lazy != 0, kind, D > kNarrowDim);
  o[0] = F;
  o[1] = kind;
  o[2] = F > 0 ? (long long)L.total : 0;
  o[3] = F > 0 ? (long long)L.spill_bytes : 0;
  return 0;
}

// The v1 kernel: x, idx0, centers, chunks_bf16, out, spill, slots and
// nslots as above; qgram (nc * 256, 256) f32, the Gram of the bf16 centers;
// csq (nc * 256,) f32, the squared norms of the f32 centers.  f32 E, every step after the
// fan-out a pool step.  Checked by the caller: M a multiple of 8 in [8, 64],
// M * R <= 256.
extern "C" int qtt_seqbeam_v1_launch(const void* x, const void* idx0, const void* centers,
                                     const void* qgram, const void* csq, const void* chunks_bf16,
                                     void* out, int B, int D, int nc, int M, int R, int passes,
                                     void* spill, void* slots, int nslots, void* stream) {
  Args a;
  size_t smem;
  const int err = v1_args(x, idx0, centers, qgram, csq, chunks_bf16, out, B, D, nc, M, R, passes,
                          spill, slots, nslots, &a, &smem);
  if (err) return err;
  return launch_v1(a, M, smem, (cudaStream_t)stream);
}

// The stage-timed build of the v1 kernel, at the JAX wrapper's defaults only
// (M=16, R=8): the arguments of qtt_seqbeam_v1_launch, then stages, a zeroed
// (blocks, 10) int64 buffer, filled as by qtt_seqbeam_v2_timed_launch.
extern "C" int qtt_seqbeam_v1_timed_launch(const void* x, const void* idx0, const void* centers,
                                           const void* qgram, const void* csq,
                                           const void* chunks_bf16, void* out, int B, int D,
                                           int nc, int M, int R, int passes, void* spill,
                                           void* slots, int nslots, void* stages, void* stream) {
  if (M != 16 || R != 8 || !stages) return (int)cudaErrorInvalidValue;
  Args a;
  size_t smem;
  const int err = v1_args(x, idx0, centers, qgram, csq, chunks_bf16, out, B, D, nc, M, R, passes,
                          spill, slots, nslots, &a, &smem);
  if (err) return err;
  a.stages = (long long*)stages;
  return launch<kF32, 16, true, kStep, false, true>(a, smem, (cudaStream_t)stream);
}
