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
// ss is the next pass's root score.  bf16 tables are summed in f32, int8
// tables exactly in int32 (the kernel works in units of the table scale).
//
// Bound: operations.  The TPU computes SG as a one-hot matmul; here a
// rescore row is a gather-sum of nc table rows, B * passes * (1 + (nc-1) M)
// rows of nc * 256 adds in all, against the FP32 add rate.  Design: one warp
// owns one frame and runs its whole search with no block-wide barrier; lane
// l owns codewords 8l .. 8l+7, so each table row is one 16-byte (bf16) or
// 8-byte (int8) load a lane, 512 or 256 contiguous bytes a warp.  The table
// (at most 8 MB at nc = 8 in bf16) stays in L2, and the M candidates of a
// frame share most of their rows, which L1 serves.  Selection uses the warp
// reductions of csrc/seqbeam.cu.  Built with --fmad=false so every f32 step
// rounds as in the plain version, which it matches on every index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCS = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxNC = 8;
constexpr int kMaxPool = 256;     // M * R
constexpr int kMaxPasses = 64;
constexpr uint32_t kLaneMask = 0xFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;

struct Args {
  const float* xc;          // (B, nc * 256), scale-divided for int8
  const int32_t* idx0;      // (B, nc)
  const float* ss0;         // (B,), scale-divided for int8
  const void* gt;           // (nc, nc * 256, 256) bf16 or int8: gt[t, s*256+i, j]
  int32_t* out;             // (B, nc)
  int B, nc, R, passes;
  uint32_t pool[kMaxPasses];  // bit t of pool[p]: step t of pass p is a pool step
};

// Packed selection key: the score clamped at 0, its 8 low mantissa bits
// replaced by the id.  Non-negative floats order like their bits.
__device__ __forceinline__ uint32_t pack_key(float s, uint32_t id) {
  const float v = s > 0.0f ? s : 0.0f;
  return (__float_as_uint(v) & ~kLaneMask) | id;
}

// Warp-wide minimum of the keys held by the lanes; the (unique) winner is
// removed from its owner's set.
__device__ __forceinline__ uint32_t extract_min(uint32_t (&keys)[8]) {
  uint32_t m = keys[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) m = min(m, keys[q]);
  const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, m);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (keys[q] == w) keys[q] = kNone;
  return w;
}

// Q(j) = 2 (SG(j) - XC_t(j)) for this lane's codewords j = 8 lane + q, where
// SG sums the nc rows ch[0..nc) of the target block gt_t in codebook order.
template <bool I8>
__device__ __forceinline__ void score_row(const void* gt_t, const int* ch, int nc,
                                          const float (&xcv)[8], int lane, float (&Q)[8]) {
  if (I8) {
    int acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0;
    for (int s = 0; s < nc; ++s) {
      const int8_t* row = reinterpret_cast<const int8_t*>(gt_t) + ((size_t)(s * kCS + ch[s])) * kCS;
      const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * lane);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] += (int)(int8_t)(w.x >> (8 * q));
        acc[q + 4] += (int)(int8_t)(w.y >> (8 * q));
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) Q[q] = 2.0f * ((float)acc[q] - xcv[q]);
  } else {
    float acc[8];
    for (int s = 0; s < nc; ++s) {
      const uint16_t* row = reinterpret_cast<const uint16_t*>(gt_t) + ((size_t)(s * kCS + ch[s])) * kCS;
      const uint4 w = *reinterpret_cast<const uint4*>(row + 8 * lane);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[2 * q] = __uint_as_float(u[q] << 16);
        v[2 * q + 1] = __uint_as_float(u[q] & 0xFFFF0000u);
      }
      if (s == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = v[q];
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] = acc[q] + v[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) Q[q] = 2.0f * (acc[q] - xcv[q]);
  }
}

// Keys of S(j) = (ss - Q(i)) + Q(j) over this lane's codewords, with Q(i)
// fetched from the lane that owns codeword i.
__device__ __forceinline__ void row_keys(const float (&Q)[8], float ss, int i, int lane,
                                         uint32_t (&keys)[8]) {
  float qi = Q[0];
#pragma unroll
  for (int q = 1; q < 8; ++q)
    if ((i & 7) == q) qi = Q[q];
  qi = __shfl_sync(0xFFFFFFFFu, qi, i >> 3);
  const float base = ss - qi;
#pragma unroll
  for (int q = 0; q < 8; ++q) keys[q] = pack_key(base + Q[q], (uint32_t)(8 * lane + q));
}

__device__ __forceinline__ void load_xc(const float* xcb, int t, int lane, float (&xcv)[8]) {
  const float4* p = reinterpret_cast<const float4*>(xcb + t * kCS + 8 * lane);
  const float4 a = p[0], b = p[1];
  xcv[0] = a.x; xcv[1] = a.y; xcv[2] = a.z; xcv[3] = a.w;
  xcv[4] = b.x; xcv[5] = b.y; xcv[6] = b.z; xcv[7] = b.w;
}

template <bool I8, int M>
__global__ void __launch_bounds__(kThreads) gramv3_kernel(const Args a) {
  __shared__ int ch_s[kWarps][2][M * kMaxNC];  // candidate index rows, double-buffered
  __shared__ uint32_t rk_s[kWarps][kMaxPool];  // top-R keys per parent
  __shared__ float ss_s[kWarps][M];
  __shared__ int selj_s[kWarps][M];
  __shared__ int selp_s[kWarps][M];
  __shared__ int sol_s[kWarps][kMaxNC];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;  // whole warps only: no block-wide barrier below
  const int nc = a.nc, R = a.R, K = nc * kCS;
  const size_t tsz = I8 ? 1 : 2;
  const char* gt = reinterpret_cast<const char*>(a.gt);
  const float* xcb = a.xc + (size_t)b * K;
  int* sol = sol_s[warp];
  float* ss = ss_s[warp];
  int* selj = selj_s[warp];
  int* selp = selp_s[warp];
  uint32_t* rk = rk_s[warp];

  if (lane < nc) sol[lane] = a.idx0[(size_t)b * nc + lane];
  float ss_root = a.ss0[b];
  __syncwarp();

  for (int p = 0; p < a.passes; ++p) {
    int cur = 0;
    int* ch = ch_s[warp][cur];
    // ---- step 0: fan out from the root to its M best children
    {
      float xcv[8], Q[8];
      uint32_t keys[8];
      load_xc(xcb, 0, lane, xcv);
      score_row<I8>(gt, sol, nc, xcv, lane, Q);
      row_keys(Q, ss_root, sol[0], lane, keys);
      for (int m = 0; m < M; ++m) {
        const uint32_t w = extract_min(keys);
        if (lane == 0) {
          selj[m] = (int)(w & kLaneMask);
          ss[m] = __uint_as_float(w & ~kLaneMask);
        }
      }
      __syncwarp();
      for (int i = lane; i < M * nc; i += 32) {
        const int m = i / nc, s = i - m * nc;
        ch[i] = s == 0 ? selj[m] : sol[s];
      }
      __syncwarp();
    }
    // ---- steps 1..nc-1
    for (int t = 1; t < nc; ++t) {
      const bool pool = (a.pool[p] >> t) & 1u;
      const void* gt_t = gt + (size_t)t * K * kCS * tsz;
      float xcv[8];
      load_xc(xcb, t, lane, xcv);
      for (int m = 0; m < M; ++m) {
        const int* row = ch + m * nc;
        float Q[8];
        uint32_t keys[8];
        score_row<I8>(gt_t, row, nc, xcv, lane, Q);
        row_keys(Q, ss[m], row[t], lane, keys);
        if (!pool) {
          // R1: each parent keeps its best child in place
          const uint32_t w = extract_min(keys);
          if (lane == 0) {
            ss[m] = __uint_as_float(w & ~kLaneMask);
            ch[m * nc + t] = (int)(w & kLaneMask);
          }
        } else {
          for (int k = 0; k < R; ++k) {
            const uint32_t w = extract_min(keys);
            if (lane == 0) rk[m * R + k] = w;
          }
        }
      }
      __syncwarp();
      if (pool) {
        // ---- top M of the M*R pool, parent id above the lane bits
        const uint32_t mbits = (uint32_t)(M - 1) << 8;
        uint32_t keys[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int e = lane + 32 * q;
          keys[q] = e < M * R ? (rk[e] & ~mbits) | ((uint32_t)(e / R) << 8) : kNone;
        }
        for (int n = 0; n < M; ++n) {
          const uint32_t w = extract_min(keys);
          if (lane == 0) {
            selj[n] = (int)(w & kLaneMask);
            selp[n] = (int)((w >> 8) & (uint32_t)(M - 1));
            ss[n] = __uint_as_float(w & ~(mbits | kLaneMask));
          }
        }
        __syncwarp();
        int* nxt = ch_s[warp][cur ^ 1];
        for (int i = lane; i < M * nc; i += 32) {
          const int n = i / nc, s = i - n * nc;
          nxt[i] = s == t ? selj[n] : ch[selp[n] * nc + s];
        }
        __syncwarp();
        cur ^= 1;
        ch = nxt;
      }
    }
    // ---- pass end: the best candidate by packed (ss, m) becomes the root
    uint32_t k = kNone;
    for (int m = lane; m < M; m += 32) k = min(k, pack_key(ss[m], (uint32_t)m));
    const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, k);
    const int best = (int)(w & kLaneMask);
    ss_root = __uint_as_float(w & ~kLaneMask);
    __syncwarp();
    if (lane < nc) sol[lane] = ch[best * nc + lane];
    __syncwarp();
  }
  if (lane < nc) a.out[(size_t)b * nc + lane] = sol[lane];
}

template <bool I8>
int launch_m(const Args& a, int M, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.B + kWarps - 1) / kWarps);
  if (blocks == 0) return (int)cudaGetLastError();
  switch (M) {
    case 8: gramv3_kernel<I8, 8><<<blocks, kThreads, 0, stream>>>(a); break;
    case 16: gramv3_kernel<I8, 16><<<blocks, kThreads, 0, stream>>>(a); break;
    case 32: gramv3_kernel<I8, 32><<<blocks, kThreads, 0, stream>>>(a); break;
    case 64: gramv3_kernel<I8, 64><<<blocks, kThreads, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xc (B, nc * 256) f32; idx0 (B, nc) int32; ss0 (B,) f32; gt (nc, nc * 256,
// 256) bf16 (g_dtype 0) or int8 (g_dtype 1); out (B, nc) int32.  pool_masks:
// `passes` host words, bit t set where step t is a pool step.  The caller
// checks shapes: nc in {2, 4, 8}, M in {8, 16, 32, 64}, 1 <= R, M * R <= 256.
extern "C" int qtt_gramv3_launch(const void* xc, const void* idx0, const void* ss0,
                                 const void* gt, void* out, int B, int nc, int M, int R,
                                 int passes, const void* pool_masks, int g_dtype, void* stream) {
  if (passes > kMaxPasses || passes < 0 || nc > kMaxNC || nc < 1 || R < 1 || M * R > kMaxPool)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.xc = (const float*)xc;
  a.idx0 = (const int32_t*)idx0;
  a.ss0 = (const float*)ss0;
  a.gt = gt;
  a.out = (int32_t*)out;
  a.B = B; a.nc = nc; a.R = R; a.passes = passes;
  for (int p = 0; p < kMaxPasses; ++p) a.pool[p] = p < passes ? ((const uint32_t*)pool_masks)[p] : 0u;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (g_dtype) {
    case 0: return launch_m<false>(a, M, s);
    case 1: return launch_m<true>(a, M, s);
  }
  return (int)cudaErrorInvalidValue;
}
