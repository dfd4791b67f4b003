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
// Bound: operations.  Per frame and pass the rescore is (1 + (nc-1) M)
// products of length D against all 256 codewords; everything else is
// O(M * D) or O(M * 256) per step.  Design: one block of 256 threads owns F
// frames, and keeps their F*M candidate error rows (double-buffered for the
// beam reorder), the root errors and the F*M x 256 score tile in shared
// memory for all passes.  The rescore runs on the tensor cores with
// mma.sync (m16n8k16 bf16 or m16n8k32 s8): each of the 8 warps owns 32
// codewords and streams their rows of C_t straight from L2 (all codebooks
// are at most 2 MB in bf16), while the candidate rows come from shared
// memory.  Selection runs one warp per candidate row (R rounds of
// __reduce_min_sync over the packed keys) and one warp per frame for the
// pool.  All f32 arithmetic is built with --fmad=false so that each
// rounding step matches the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCS = 256;          // codebook size (SEQBEAM_SUPPORTED)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPasses = 64;
constexpr int kMaxChunks = 8;     // D <= 1024: D / 128 chunks of 4 per lane
constexpr int kMaxRows = 64;      // frames x candidates per block
constexpr int kXS = kCS + 8;      // padded row stride of the score tile (floats)
constexpr size_t kMaxSmem = 232448;
constexpr uint32_t kLaneMask = 0xFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr float kInv127 = (float)(1.0 / 127.0);

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum { kStep = 0, kPass = 1, kBound = 2 };

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
  int32_t* out;             // (B, nc)
  int B, D, nc, R, passes, F;
  uint32_t pool[kMaxPasses];  // bit t of pool[p]: step t of pass p is a pool step
};

struct Layout {
  int rows;          // F * M candidate rows
  int xrows;         // rows rounded up to the rescore's 16-row tiles
  int e_stride;      // bytes per candidate row (padded: no bank conflicts)
  int er_stride;     // floats per root-error row
  size_t e0, e1, er, xs, srow, sc0, sc1, rsc, ss, ss0, ch0, ch1, sol, selj, selp, jdef, rkeys;
  size_t total;
};

__host__ __device__ inline size_t take(size_t* off, size_t bytes) {
  const size_t at = *off;
  *off = (at + bytes + 15) & ~(size_t)15;
  return at;
}

__host__ __device__ inline Layout make_layout(int et, int M, int F, int D, int nc, int R,
                                              bool lazy) {
  Layout L;
  const int esize = et == kF32 ? 4 : (et == kBF16 ? 2 : 1);
  L.rows = F * M;
  L.xrows = (L.rows + 15) / 16 * 16;
  L.e_stride = D * esize + 16;
  L.er_stride = D + 4;
  const size_t rows = (size_t)L.rows;
  size_t off = 0;
  L.e0 = take(&off, rows * L.e_stride);
  L.e1 = take(&off, rows * L.e_stride);
  L.er = take(&off, (size_t)F * L.er_stride * 4);
  L.xs = take(&off, (size_t)L.xrows * kXS * 4);
  L.srow = take(&off, (size_t)F * kCS * 4);
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
  L.total = off;
  return L;
}

__device__ __forceinline__ float bf2f(uint16_t h) { return __uint_as_float((uint32_t)h << 16); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Packed selection key: the score clamped at 0, its 8 low mantissa bits
// replaced by the lane id.  Non-negative floats order like their bits.
__device__ __forceinline__ uint32_t pack_key(float s, uint32_t id) {
  const float v = s > 0.0f ? s : 0.0f;
  return (__float_as_uint(v) & ~kLaneMask) | id;
}

// Warp-wide minimum of the keys held by the lanes; the (unique) winner is
// removed from its owner's set.
template <int N>
__device__ __forceinline__ uint32_t extract_min(uint32_t (&keys)[N]) {
  uint32_t m = keys[0];
#pragma unroll
  for (int q = 1; q < N; ++q) m = min(m, keys[q]);
  const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, m);
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (keys[q] == w) keys[q] = kNone;
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive elements (k, k+1) of row r of A as a bf16 pair; rows at or
// past `rows` read as zero.  A_F32: the row holds f32 (rounded to bf16
// here, as the TPU kernel's matmul casts its operand); else bf16.
template <bool A_F32>
__device__ __forceinline__ uint32_t load_a(const unsigned char* A, int stride, int rows, int r, int k) {
  if (r >= rows) return 0u;
  if (A_F32) {
    const float2 v = *reinterpret_cast<const float2*>(A + (size_t)r * stride + (size_t)k * 4);
    return pack_bf16x2(v.x, v.y);
  }
  return *reinterpret_cast<const uint32_t*>(A + (size_t)r * stride + (size_t)k * 2);
}

// X[r, n] = sum_k bf16(A[r, k]) * C_t[n, k] in f32 for r < 16 * mtiles and
// all 256 codewords n.  Warp w owns codewords [32 w, 32 w + 32).
template <bool A_F32>
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
          const uint32_t a[4] = {
              load_a<A_F32>(A, stride, rows, r0, k0 + 2 * q),
              load_a<A_F32>(A, stride, rows, r1, k0 + 2 * q),
              load_a<A_F32>(A, stride, rows, r0, k0 + 8 + 2 * q),
              load_a<A_F32>(A, stride, rows, r1, k0 + 8 + 2 * q)};
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

// X[r, n] = f32(sum_k A8[r, k] * C8_t[n, k]) * rsc[r]: the int8 rescore,
// exact in int32, dequantized by the row scale x codebook scale.
__device__ void rescore_s8(const unsigned char* A, int stride, int mtiles,
                           const int8_t* __restrict__ Ct, int D, const float* rsc, float* X,
                           int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int n0 = warp * 32;
  for (int mt0 = 0; mt0 < mtiles; mt0 += 4) {
    int acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[mi][nt][u] = 0;
    for (int k0 = 0; k0 < D; k0 += 32) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* bp = Ct + (size_t)(n0 + nt * 8 + g) * D + k0 + 4 * q;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mt0 + mi < mtiles) {
          const int r0 = (mt0 + mi) * 16 + g, r1 = r0 + 8;
          const uint32_t a[4] = {
              *reinterpret_cast<const uint32_t*>(A + (size_t)r0 * stride + k0 + 4 * q),
              *reinterpret_cast<const uint32_t*>(A + (size_t)r1 * stride + k0 + 4 * q),
              *reinterpret_cast<const uint32_t*>(A + (size_t)r0 * stride + k0 + 16 + 4 * q),
              *reinterpret_cast<const uint32_t*>(A + (size_t)r1 * stride + k0 + 16 + 4 * q)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mi][nt], a, b[nt]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mt0 + mi < mtiles) {
        const int r0 = (mt0 + mi) * 16 + g, r1 = r0 + 8;
        const float s0 = rsc[r0], s1 = rsc[r1];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + nt * 8 + 2 * q;
          X[r0 * kXS + col] = (float)acc[mi][nt][0] * s0;
          X[r0 * kXS + col + 1] = (float)acc[mi][nt][1] * s0;
          X[r1 * kXS + col] = (float)acc[mi][nt][2] * s1;
          X[r1 * kXS + col + 1] = (float)acc[mi][nt][3] * s1;
        }
      }
    }
  }
}

// Keys of one candidate's row scores; lane l holds codewords l, l + 32,
// ..., l + 224.  v2: S[j] = (base + shared[j]) + 2 cross[j] with shared the
// Gmod row; v1: S[j] = (base + csq[j]) + 2 (cross[j] - q[j]) with q the
// Gram row (`sr`) and csq the codebook's squared norms.
template <bool V1>
__device__ __forceinline__ void row_keys(const float* xr, const float* sr, const float* csq,
                                         float base, int lane, uint32_t (&keys)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = lane + 32 * q;
    const float s = V1 ? (base + csq[j]) + 2.0f * (xr[j] - sr[j]) : (base + sr[j]) + 2.0f * xr[j];
    keys[q] = pack_key(s, (uint32_t)j);
  }
}

// The score's per-row constant: v2 (ss - 2 Ec) - ccn with ccn = Gmod[i, i];
// v1 (ss - 2 Ec) + cc with cc = q[i].
template <bool V1>
__device__ __forceinline__ float row_base(float ss, float ec, float si) {
  return V1 ? (ss - 2.0f * ec) + si : (ss - 2.0f * ec) - si;
}

template <int ET>
__device__ __forceinline__ void load_row4(const unsigned char* row, int d, float (&v)[4]) {
  if (ET == kF32) {
    const float4 w = *reinterpret_cast<const float4*>(row + (size_t)d * 4);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else if (ET == kBF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + (size_t)d * 2);
    v[0] = __uint_as_float(w.x << 16); v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16); v[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
    const char4 w = *reinterpret_cast<const char4*>(row + d);
    v[0] = (float)w.x; v[1] = (float)w.y; v[2] = (float)w.z; v[3] = (float)w.w;
  }
}

template <int ET>
__device__ __forceinline__ void store_row4(unsigned char* row, int d, const float (&v)[4]) {
  if (ET == kF32) {
    *reinterpret_cast<float4*>(row + (size_t)d * 4) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 w;
    w.x = pack_bf16x2(v[0], v[1]);
    w.y = pack_bf16x2(v[2], v[3]);
    *reinterpret_cast<uint2*>(row + (size_t)d * 2) = w;
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
  const char4 pj = *reinterpret_cast<const char4*>(cj + d);
  const char4 pi = *reinterpret_cast<const char4*>(ci + d);
  dv[0] = (float)((int)pj.x - (int)pi.x);
  dv[1] = (float)((int)pj.y - (int)pi.y);
  dv[2] = (float)((int)pj.z - (int)pi.z);
  dv[3] = (float)((int)pj.w - (int)pi.w);
}

// One warp extends candidate row r:
//   E_dst[r] = E_src[src_row] + (c_t[j] - c_t[i])
// plus, with LAZY and jp >= 0, the deferred delta c_{t-1}[jp] - c_{t-1}[ip].
// f32/bf16: in f32, stored in the E type.  int8 (not first): in csc[t]
// units, q * (s / csc) + (c8[j] - c8[i]) [+ (c8'[jp] - c8'[ip]) * (csc' /
// csc)], requantized by the REQ rule, scale s_new * csc stored; kPass adds
// round((c8[j] - c8[i]) * (csc / s)) to q and keeps s.  first: the source is
// the f32 root error, and int8 quantizes the absolute f32 sum (scale from the
// extended row, or from the root for kPass).
template <int ET, bool FIRST, int REQ, bool LAZY>
__device__ void extend_row(const Args& a, int D, int t, int it, int j, int ip, int jp,
                           const unsigned char* src, unsigned char* dst, float src_scale,
                           float* dst_scale, float csc_t, int lane) {
  constexpr bool I8 = ET == kI8 && !FIRST;
  const bool prev = LAZY && jp >= 0;
  const int nchunk = D / 128;
  float ef[kMaxChunks][4];
  float sadj = 0.0f, rprev = 0.0f, col = 0.0f, vmax = 0.0f;
  if (I8) {
    const float inv_csc = 1.0f / csc_t;
    sadj = src_scale * inv_csc;
    if (prev) rprev = a.csc[t - 1] * inv_csc;
    if (REQ == kPass) col = csc_t * (1.0f / src_scale);
  }
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    if (k < nchunk) {
      const int d = 4 * (lane + 32 * k);
      float v[4], dv[4];
      if (FIRST) {
        const float4 w = *reinterpret_cast<const float4*>(src + (size_t)d * 4);
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
      } else {
        load_row4<ET>(src, d, v);
      }
      if (I8) {
        i8_delta4(a.C8 + ((size_t)t * kCS + j) * D, a.C8 + ((size_t)t * kCS + it) * D, d, dv);
        if (REQ == kPass) {
#pragma unroll
          for (int u = 0; u < 4; ++u) ef[k][u] = v[u] + rintf(dv[u] * col);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) ef[k][u] = v[u] * sadj + dv[u];
          if (prev) {
            float pv[4];
            i8_delta4(a.C8 + ((size_t)(t - 1) * kCS + jp) * D,
                      a.C8 + ((size_t)(t - 1) * kCS + ip) * D, d, pv);
#pragma unroll
            for (int u = 0; u < 4; ++u) ef[k][u] = ef[k][u] + pv[u] * rprev;
          }
        }
      } else {
        bf16_delta4(a.C + ((size_t)t * kCS + j) * D, a.C + ((size_t)t * kCS + it) * D, d, dv);
        if (prev) {
          float pv[4];
          bf16_delta4(a.C + ((size_t)(t - 1) * kCS + jp) * D,
                      a.C + ((size_t)(t - 1) * kCS + ip) * D, d, pv);
#pragma unroll
          for (int u = 0; u < 4; ++u) dv[u] = dv[u] + pv[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) ef[k][u] = v[u] + dv[u];
        if (FIRST && ET == kI8 && REQ == kPass)
#pragma unroll
          for (int u = 0; u < 4; ++u) vmax = fmaxf(vmax, fabsf(v[u]));
      }
      if (ET != kI8) store_row4<ET>(dst, d, ef[k]);
    }
  }
  if (ET != kI8) return;
  float s;
  if (!FIRST && REQ == kPass) {
    s = src_scale;  // frozen for the pass; ef already holds the new q
  } else {
    float amax = vmax;  // kPass, first: the root error's
    if (!(FIRST && REQ == kPass)) {
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k)
        if (k < nchunk)
#pragma unroll
          for (int u = 0; u < 4; ++u) amax = fmaxf(amax, fabsf(ef[k][u]));
    }
    amax = warp_max(amax);
    s = (!FIRST && REQ == kBound) ? sadj + a.cmax[t] * kInv127 : fmaxf(amax * kInv127, 1e-20f);
    const float inv = 1.0f / s;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
      if (k < nchunk)
#pragma unroll
        for (int u = 0; u < 4; ++u) ef[k][u] = rintf(ef[k][u] * inv);
  }
  // step requant never leaves [-127, 127]: its scale is the row's max
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    if (k < nchunk) {
      const int d = 4 * (lane + 32 * k);
      char4 w;
      w.x = (signed char)(int)(REQ == kStep ? ef[k][0] : clip127(ef[k][0]));
      w.y = (signed char)(int)(REQ == kStep ? ef[k][1] : clip127(ef[k][1]));
      w.z = (signed char)(int)(REQ == kStep ? ef[k][2] : clip127(ef[k][2]));
      w.w = (signed char)(int)(REQ == kStep ? ef[k][3] : clip127(ef[k][3]));
      *reinterpret_cast<char4*>(dst + d) = w;
    }
  }
  if (lane == 0) *dst_scale = (FIRST || REQ == kPass) ? s : s * csc_t;
}

// V1: the v1 kernel (f32 E, every step a pool step, v1's score and pool
// packing); it reads qg/csq in place of gmod.  REQ: the int8 requant rule
// (kStep otherwise).  LAZY: lazy_r1 (v2, kStep).
template <int ET, int M, bool V1, int REQ, bool LAZY>
__global__ void __launch_bounds__(kThreads, 1) seqbeam_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, D = a.D, nc = a.nc, R = a.R;
  const Layout L = make_layout(ET, M, F, D, nc, R, LAZY);
  const int RW = L.rows, mtiles = L.xrows / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int fb = blockIdx.x * F;

  unsigned char* E[2] = {smem + L.e0, smem + L.e1};
  float* Er = reinterpret_cast<float*>(smem + L.er);
  float* X = reinterpret_cast<float*>(smem + L.xs);
  float* srow = reinterpret_cast<float*>(smem + L.srow);
  float* sc[2] = {reinterpret_cast<float*>(smem + L.sc0), reinterpret_cast<float*>(smem + L.sc1)};
  float* rsc = reinterpret_cast<float*>(smem + L.rsc);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  float* ss0 = reinterpret_cast<float*>(smem + L.ss0);
  int* ch[2] = {reinterpret_cast<int*>(smem + L.ch0), reinterpret_cast<int*>(smem + L.ch1)};
  int* sol = reinterpret_cast<int*>(smem + L.sol);
  int* selj = reinterpret_cast<int*>(smem + L.selj);
  int* selp = reinterpret_cast<int*>(smem + L.selp);
  int* jdef = reinterpret_cast<int*>(smem + L.jdef);
  uint32_t* rkeys = reinterpret_cast<uint32_t*>(smem + L.rkeys);

  // the per-frame score row of codebook t: v2 Gmod_t[sol_t, :], v1 q_t[sol_t, :]
  auto load_srow = [&](int t) {
    for (int i = tid; i < F * kCS; i += kThreads) {
      const int f = i / kCS;
      const size_t at = ((size_t)t * kCS + sol[f * nc + t]) * kCS + (i % kCS);
      srow[i] = V1 ? a.qg[at] : bf2f(a.gmod[at]);
    }
  };

  for (int i = tid; i < F * nc; i += kThreads) {
    const int b = fb + i / nc;
    sol[i] = b < a.B ? a.idx0[(size_t)b * nc + i % nc] : 0;
  }
  __syncthreads();

  for (int p = 0; p < a.passes; ++p) {
    // ---- root: E = -x + sum_s bf16(C_s[sol_s]) in f32, codebook order
    for (int i = tid; i < F * D; i += kThreads) {
      const int f = i / D, d = i - f * D;
      const int b = fb + f;
      float e = b < a.B ? -a.x[(size_t)b * D + d] : 0.0f;
      for (int s = 0; s < nc; ++s) e = e + bf2f(a.C[((size_t)s * kCS + sol[f * nc + s]) * D + d]);
      Er[f * L.er_stride + d] = e;
    }
    load_srow(0);
    __syncthreads();
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
    rescore_bf16<true>(reinterpret_cast<const unsigned char*>(Er), L.er_stride * 4, F, 1, a.C, D, X,
                       warp, lane);
    __syncthreads();
    for (int f = warp; f < F; f += kWarps) {
      const int i0 = sol[f * nc];
      const float* xr = X + f * kXS;
      const float* sr = srow + f * kCS;
      uint32_t keys[8];
      row_keys<V1>(xr, sr, a.csq, row_base<V1>(ss0[f], xr[i0], sr[i0]), lane, keys);
      for (int m = 0; m < M; ++m) {
        const uint32_t w = extract_min(keys);
        if (lane == 0) {
          selj[f * M + m] = (int)(w & kLaneMask);
          ss[f * M + m] = __uint_as_float(w & ~kLaneMask);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < RW * nc; i += kThreads) {
      const int r = i / nc, s = i - r * nc;
      ch[0][i] = s == 0 ? selj[r] : sol[(r / M) * nc + s];
    }
    for (int r = warp; r < RW; r += kWarps) {
      const int f = r / M;
      extend_row<ET, true, REQ, LAZY>(a, D, 0, sol[f * nc], selj[r], -1, -1,
                           reinterpret_cast<const unsigned char*>(Er + f * L.er_stride),
                           E[0] + (size_t)r * L.e_stride, 0.0f, sc[0] + r,
                           ET == kI8 ? a.csc[0] : 1.0f, lane);
    }
    __syncthreads();

    int cur = 0;
    bool pend = false;  // lazy_r1: step t-1 deferred its E update (jdef)
    for (int t = 1; t < nc; ++t) {
      const bool pool = V1 || ((a.pool[p] >> t) & 1u);
      const bool last = t == nc - 1;
      const bool defer = LAZY && !pool && !last;
      const float csc_t = ET == kI8 ? a.csc[t] : 1.0f;
      load_srow(t);
      if (ET == kI8)
        for (int r = tid; r < RW; r += kThreads) rsc[r] = sc[cur][r] * csc_t;
      __syncthreads();
      // ---- rescore all candidates against codebook t
      if (ET == kI8)
        rescore_s8(E[cur], L.e_stride, mtiles, a.C8 + (size_t)t * kCS * D, D, rsc, X, warp, lane);
      else if (ET == kF32)
        rescore_bf16<true>(E[cur], L.e_stride, RW, mtiles, a.C + (size_t)t * kCS * D, D, X, warp,
                           lane);
      else
        rescore_bf16<false>(E[cur], L.e_stride, RW, mtiles, a.C + (size_t)t * kCS * D, D, X, warp,
                            lane);
      __syncthreads();
      // ---- score assembly and per-row selection
      for (int r = warp; r < RW; r += kWarps) {
        const int f = r / M;
        const int it = sol[f * nc + t];
        float* xr = X + r * kXS;
        const float* sr = srow + f * kCS;
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
        row_keys<V1>(xr, sr, a.csq + (size_t)t * kCS, row_base<V1>(ss[r], xr[it], sr[it]), lane,
                     keys);
        if (!pool) {
          // R1: each parent keeps its best child in place
          const uint32_t w = extract_min(keys);
          if (lane == 0) {
            selj[r] = (int)(w & kLaneMask);
            selp[r] = r - f * M;
            ss[r] = __uint_as_float(w & ~kLaneMask);
            ch[cur][r * nc + t] = (int)(w & kLaneMask);
            if (defer) jdef[r] = (int)(w & kLaneMask);
          }
        } else {
          for (int k = 0; k < R; ++k) {
            const uint32_t w = extract_min(keys);
            if (lane == 0) rkeys[r * R + k] = w;
          }
        }
      }
      __syncthreads();
      if (pool) {
        // ---- top-M of each frame's M*R pool.  v2: the parent id above
        // the lane bits; v1: the pool lane m*R + r in the lane bits
        const uint32_t mbits = (uint32_t)(M - 1) << 8;
        for (int f = warp; f < F; f += kWarps) {
          const uint32_t* fk = rkeys + f * M * R;
          uint32_t keys[16];
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int e = lane + 32 * q;
            keys[q] = e >= M * R ? kNone
                      : V1       ? (fk[e] & ~kLaneMask) | (uint32_t)e
                                 : (fk[e] & ~mbits) | ((uint32_t)(e / R) << 8);
          }
          for (int n = 0; n < M; ++n) {
            const uint32_t w = extract_min(keys);
            if (lane == 0) {
              if (V1) {
                const int e = (int)(w & kLaneMask);
                selj[f * M + n] = (int)(fk[e] & kLaneMask);
                selp[f * M + n] = e / R;
                ss[f * M + n] = __uint_as_float(w & ~kLaneMask);
              } else {
                selj[f * M + n] = (int)(w & kLaneMask);
                selp[f * M + n] = (int)((w >> 8) & (uint32_t)(M - 1));
                ss[f * M + n] = __uint_as_float(w & ~(mbits | kLaneMask));
              }
            }
          }
        }
        __syncthreads();
        for (int i = tid; i < RW * nc; i += kThreads) {
          const int r = i / nc, s = i - r * nc;
          const int f = r / M;
          ch[cur ^ 1][i] = s == t ? selj[r] : ch[cur][(f * M + selp[r]) * nc + s];
        }
      }
      // ---- extension (none on the last step of a pass, or a deferring R1 step)
      if (!last && !defer) {
        const int dst = pool ? cur ^ 1 : cur;
        for (int r = warp; r < RW; r += kWarps) {
          const int f = r / M;
          const int src_row = f * M + selp[r];
          extend_row<ET, false, REQ, LAZY>(a, D, t, sol[f * nc + t], selj[r],
                                pend ? sol[f * nc + t - 1] : -1, pend ? jdef[src_row] : -1,
                                E[cur] + (size_t)src_row * L.e_stride,
                                E[dst] + (size_t)r * L.e_stride,
                                ET == kI8 ? sc[cur][src_row] : 0.0f, sc[dst] + r, csc_t, lane);
        }
      }
      if (pool) cur ^= 1;
      pend = defer;
      __syncthreads();
    }
    // ---- pass end: the best candidate by packed (ss, m) becomes the root
    for (int f = warp; f < F; f += kWarps) {
      uint32_t k = kNone;
      for (int m = lane; m < M; m += 32) k = min(k, pack_key(ss[f * M + m], (uint32_t)m));
      const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, k);
      const int best = (int)(w & kLaneMask);
      if (lane < nc) sol[f * nc + lane] = ch[cur][(f * M + best) * nc + lane];
    }
    __syncthreads();
  }
  for (int i = tid; i < F * nc; i += kThreads) {
    const int b = fb + i / nc;
    if (b < a.B) a.out[(size_t)b * nc + i % nc] = sol[i];
  }
}

template <int ET, int M, bool V1, int REQ, bool LAZY>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(seqbeam_kernel<ET, M, V1, REQ, LAZY>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a.B + a.F - 1) / a.F);
  if (blocks > 0) seqbeam_kernel<ET, M, V1, REQ, LAZY><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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

// Frames per block for a configuration: the most (F * M <= 64 candidate
// rows, at least 16) whose shared memory fits; 0 if none does.
int frames_per_block(int e_dtype, int M, int D, int nc, int R, bool lazy) {
  for (int F = kMaxRows / M; F >= 1 && F * M >= 16; F /= 2)
    if (make_layout(e_dtype, M, F, D, nc, R, lazy).total <= kMaxSmem) return F;
  return 0;
}

Args make_args(const void* x, const void* idx0, const void* centers, void* out, int B, int D,
               int nc, int R, int passes) {
  Args a = {};
  a.x = (const float*)x;
  a.idx0 = (const int32_t*)idx0;
  a.C = (const uint16_t*)centers;
  a.out = (int32_t*)out;
  a.B = B; a.D = D; a.nc = nc; a.R = R; a.passes = passes;
  return a;
}

}  // namespace

// x (B, D) f32; idx0 (B, nc) int32; centers (nc * 256, D) bf16; gmod
// (nc * 256, 256) bf16; centers_i8 (nc * 256, D) int8 and csc (nc,) f32 for
// e_dtype 2 (int8), else null; cmax (nc,) f32 for requant 2 ("bound"), else
// null; gx (nc * 256, 256) bf16 for lazy != 0, else null; out (B, nc)
// int32.  pool_masks: `passes` host words, bit t set where step t is a pool
// step.  e_dtype: 0 f32, 1 bf16, 2 int8.  requant: 0 step, 1 pass, 2 bound
// (int8 only).  Shapes and combinations are checked by the caller: D % 128
// == 0, D <= 1024, nc even and <= 16, M in {8, 16, 32, 64}, M * R <= 512;
// with lazy, no deferring R1 step is followed by another R1 step.
extern "C" int qtt_seqbeam_v2_launch(const void* x, const void* idx0, const void* centers,
                                     const void* gmod, const void* centers_i8, const void* csc,
                                     const void* cmax, const void* gx, void* out, int B, int D,
                                     int nc, int M, int R, int passes, const void* pool_masks,
                                     int e_dtype, int requant, int lazy, void* stream) {
  if (passes > kMaxPasses || passes < 0 || requant < kStep || requant > kBound)
    return (int)cudaErrorInvalidValue;
  if ((e_dtype == kI8 && !csc) || (requant != kStep && (e_dtype != kI8 || lazy)) ||
      (requant == kBound && !cmax) || (lazy && !gx))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(x, idx0, centers, out, B, D, nc, R, passes);
  a.gmod = (const uint16_t*)gmod;
  a.C8 = (const int8_t*)centers_i8;
  a.csc = (const float*)csc;
  a.cmax = (const float*)cmax;
  a.gx = (const uint16_t*)gx;
  for (int p = 0; p < kMaxPasses; ++p) a.pool[p] = p < passes ? ((const uint32_t*)pool_masks)[p] : 0u;
  a.F = frames_per_block(e_dtype, M, D, nc, R, lazy != 0);
  if (a.F == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(e_dtype, M, a.F, D, nc, R, lazy != 0).total;
  return launch_v2(a, e_dtype, M, requant, lazy != 0, smem, (cudaStream_t)stream);
}

// The v1 kernel: x, idx0, centers and out as above; qgram (nc * 256, 256)
// f32, the Gram of the bf16 centers; csq (nc * 256,) f32, the squared norms
// of the f32 centers.  f32 E, every step after the fan-out a pool step.
// Checked by the caller: M a multiple of 8 in [8, 64], M * R <= 256.
extern "C" int qtt_seqbeam_v1_launch(const void* x, const void* idx0, const void* centers,
                                     const void* qgram, const void* csq, void* out, int B, int D,
                                     int nc, int M, int R, int passes, void* stream) {
  if (passes > kMaxPasses || passes < 0 || M * R > kCS) return (int)cudaErrorInvalidValue;
  Args a = make_args(x, idx0, centers, out, B, D, nc, R, passes);
  a.qg = (const float*)qgram;
  a.csq = (const float*)csq;
  a.F = frames_per_block(kF32, M, D, nc, R, false);
  if (a.F == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(kF32, M, a.F, D, nc, R, false).total;
  return launch_v1(a, M, smem, (cudaStream_t)stream);
}
