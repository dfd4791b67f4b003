"""Fused sequential-beam encode (seqbeam v1 and v2).

Counterpart of ``quantization_tpu/ops/seqbeam.py::seqbeam_encode_indexes``.
An M-wide beam sweeps the codebooks in order for ``passes`` passes; at each
codebook every candidate is rescored against all 256 codewords and the beam
is re-selected.  The CUDA kernels (``csrc/seqbeam.cu``: v2 and, as a variant
of the same kernel with its own entry point, v1) keep a tile of frames'
candidate errors, scores and beam bookkeeping in shared memory for all
passes; :func:`seqbeam_plain` and :func:`seqbeam_v1_plain` are the same
functions in plain PyTorch, step for step, and are what a CPU tensor runs.

Semantics of v2 (``impl="v2"``) carried over from the TPU kernel, each of
which changes results:

* per pass, the root error ``E = -x + sum_s bf16(C_s[sol_s])`` in f32,
  accumulated in codebook order, recomputed from the winner;
* step 0 rescores the root only and fans out to its M best children;
* a step's score is ``((ss - 2 E.c_i) - ccn) + shared[j] + 2 E.c_j`` with
  ``shared = Gmod_t[i]`` (``Gmod = csq_j - 2 c_i.c_j``, f32 cast to bf16) and
  ``ccn = shared[i]`` — dropping ccn costs +17% relative error;
* selection by packed mantissa: scores clamped at 0, the 8 low mantissa
  bits replaced by the codeword id, lowest id on ties, and the truncated
  value carried forward as the next step's ``ss``;
* a pool step keeps the top R children per parent, then the top M of the
  M*R pool with the parent id overlaid on mantissa bits 8..8+log2(M)-1; an
  R1 step keeps each parent's best child in its slot;
* ``E_child = E_parent + (c_t[j] - c_t[i])`` in f32, stored in ``e_dtype``;
  int8 E works in units of the codebook scale and requantizes each row
  after every extension (``requant="step"``: ``s = max(max|e| / 127,
  1e-20)``, round half to even), or keeps the fan-out's root scale for the
  whole pass (``"pass"``: ``q += round(dc8 * (csc / s0))``, clipped), or
  grows the parent's scale by the codebook's worst-case step (``"bound"``:
  ``s = s_parent / csc + cmax / 127``);
* ``lazy_r1``: an R1 step that is neither first nor last defers its E
  update; the next (pool) step corrects its rescore by the cross-codebook
  Gram block ``Gx_t[j'] - Gx_t[i']`` and applies both codewords' deltas in
  its move, the deferred one taken from the destination's parent slot;
* the pass ends on the candidate with the smallest packed (ss, m).

v1 (``impl="v1"``, f32 E and all-pool steps only) differs in the score
``((ss - 2 Ec + cc) + csq[j]) + 2 (cross - q[j])`` with ``q`` the row of the
f32 Gram of the bf16 codebook at the current index and ``csq`` the f32
squared norms of the f32 centers, and in the pool: the top-R values are
repacked with the pool lane ``m R + r`` in their low 8 bits, and the parent
is ``lane // R``.

The Mosaic scheduling knobs of the TPU wrapper (``interleave``,
``zip_skew``, ``cross_value``, ``reorder``, ``sel_impl``, ``block_b``) give
bit-identical results there by contract, and are accepted and ignored here,
except that a combination the TPU wrapper asserts against raises ValueError
(:func:`_check_knobs`).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
import weakref
from typing import Optional, Tuple

import torch

from ..core import search as _search
from ..core.types import QuantizerConfig, QuantizerParams, scaled_centers
from ..utils.device import dispatch
from ..utils.spans import span
from . import cuda_build
from .cuda_build import CudaKernel

LANE_BITS = 8
LANE_MASK = (1 << LANE_BITS) - 1
E_DTYPES = {"f32": (0, torch.float32), "bf16": (1, torch.bfloat16), "int8": (2, torch.int8)}
REQUANTS = {"step": 0, "pass": 1, "bound": 2}
MAX_PASSES = 64
SM_SHARED_BYTES = 233472  # an H100 SM's shared memory, blocks' 1 KB reserves included

# the spill layout's arguments: scratch slots, their claim flags, their count
_SPILL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
SEQBEAM_KERNEL = CudaKernel(
    "seqbeam", "qtt_seqbeam_v2_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p] + [ctypes.c_int] * 3
    + _SPILL_ARGS + [ctypes.c_void_p],
)
SEQBEAM_V1_KERNEL = CudaKernel(
    "seqbeam", "qtt_seqbeam_v1_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _SPILL_ARGS + [ctypes.c_void_p],
)
# the v2 kernel's stage-timed build (the auto ladder's two rungs only)
SEQBEAM_TIMED_KERNEL = CudaKernel(
    "seqbeam", "qtt_seqbeam_v2_timed_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p] + [ctypes.c_int] * 3
    + _SPILL_ARGS + [ctypes.c_void_p] * 2,
)
# the v1 kernel's stage-timed build (the JAX wrapper's defaults, M=16, R=8)
SEQBEAM_V1_TIMED_KERNEL = CudaKernel(
    "seqbeam", "qtt_seqbeam_v1_timed_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _SPILL_ARGS + [ctypes.c_void_p] * 2,
)
# their columns: per block, each stage's clock64() cycles summed over the
# block's warps, then the block's own cycles and nanoseconds
STAGES = ("root", "load_srow", "rescore", "selection", "pool", "reorder", "extension", "barrier")
# the kernel's layout of (e_dtype code, M, D, nc, R, lazy) into a 4-element
# int64 buffer: frames a block (0 where none fits), the kind, shared-memory
# bytes and spill-slot bytes; f32 E's is v1's too
LAYOUT = cuda_build.CFunction("seqbeam", "qtt_seqbeam_layout",
                              [ctypes.c_int] * 6 + [ctypes.c_void_p])
LAYOUT_KINDS = ("full", "compact", "spill")
# the kernels' launches (v1, v2 and the stage-timed builds) by layout kind
LAYOUT_LAUNCHES = dict.fromkeys(LAYOUT_KINDS, 0)
# the widest dim every beam runs at on the card; above it, up to 1280, the
# kernel's wide instantiations run auto's rungs only (see _check_wide)
NARROW_DIM = 1024


def SEQBEAM_SUPPORTED(config: QuantizerConfig) -> bool:
    """Kernel constraints: flagship-family configs only; everything else
    falls back to the pair-tree beam.  Above dim 1024 the card runs auto's
    beams only (:func:`seqbeam_layout` refuses the others)."""
    return (
        config.codebook_size == 256
        and config.dim % 128 == 0
        and 128 <= config.dim <= 1280
        and config.num_codebooks in (2, 4, 8, 16)
    )


def _normalize_pool_mask(pool_mask, nc: int, passes: int):
    """Normalize a pool/R1 step schedule to a per-pass tuple of
    per-codebook bool tuples.  ``None`` passes through (all-pool).  Accepts
    named schedules ("altparity" — pool even codebooks on even passes / odd
    on odd; "allfirst"/"alllast" — one all-pool pass first/last,
    parity-masked otherwise), one per-codebook tuple (applied to every
    pass), or explicit per-pass tuples."""
    if pool_mask is None:
        return None
    if isinstance(pool_mask, str):
        even = tuple(t % 2 == 0 for t in range(nc))
        odd = tuple(t % 2 == 1 for t in range(nc))
        alt = tuple(even if p % 2 == 0 else odd for p in range(passes))
        if pool_mask == "altparity":
            return alt
        if pool_mask == "allfirst":
            return ((True,) * nc,) + alt[: passes - 1]
        if pool_mask == "alllast":
            return alt[: passes - 1] + ((True,) * nc,)
        raise ValueError(f"unknown pool_mask schedule {pool_mask!r}")
    if isinstance(pool_mask[0], (tuple, list)):
        pm = tuple(tuple(bool(b) for b in m) for m in pool_mask)
        if len(pm) != passes or any(len(m) != nc for m in pm):
            raise ValueError(f"pool_mask {pm} does not match passes={passes}, nc={nc}")
        return pm
    pm = tuple(bool(b) for b in pool_mask)
    if len(pm) != nc:
        raise ValueError(f"pool_mask {pm} does not match nc={nc}")
    return (pm,) * passes


def pool_bits(pool_mask, nc: int, passes: int) -> Tuple[int, ...]:
    """Per-pass bit words: bit t set where step t of that pass is a pool
    step (step 0 is always the fan-out)."""
    pm = _normalize_pool_mask(pool_mask, nc, passes)
    if pm is None:
        return ((1 << nc) - 1,) * passes
    return tuple(sum(1 << t for t in range(nc) if m[t]) for m in pm)


@dataclasses.dataclass
class SeqbeamTables:
    """The kernel's codebook inputs, prepared from the scaled centers; each
    optional table is made only for the variant that reads it."""

    centers_bf16: torch.Tensor  # (nc, cs, D) bf16
    gmod_bf16: Optional[torch.Tensor] = None  # (nc, cs, cs) bf16: csq[t, j] - 2 c_t(i).c_t(j) (v2)
    centers_i8: Optional[torch.Tensor] = None  # (nc, cs, D) int8, units of csc
    csc: Optional[torch.Tensor] = None  # (nc,) f32 per-codebook int8 scales
    cmax: Optional[torch.Tensor] = None  # (nc,) f32 max_d (max_j - min_j) c8 (requant "bound")
    gx_bf16: Optional[torch.Tensor] = None  # (nc, cs, cs) bf16 C_{t-1}.C_t^T, block 0 zero (lazy)
    cs_sumsq: Optional[torch.Tensor] = None  # (nc, cs) f32 |c|^2 of the f32 centers (v1)
    q_gram: Optional[torch.Tensor] = None  # (nc, cs, cs) f32 Gram of the bf16 centers (v1)
    # the bf16 centers as the kernels' ring chunks; int8 E: the int8 centers too
    chunks_bf16: Optional[torch.Tensor] = None
    chunks_i8: Optional[torch.Tensor] = None


def seqbeam_tables(centers: torch.Tensor, e_dtype: str = "f32", impl: str = "v2",
                   requant: str = "step", lazy_r1: bool = False) -> SeqbeamTables:
    """Tables from (nc, cs, D) f32 scaled centers: the bf16 centers and, for
    v2, the bf16 modified Gram blocks (computed in f32); for int8 E the
    per-codebook symmetric int8 centers with scale ``amax / 127`` and, for
    ``requant="bound"``, each codebook's worst-case |c8(j) - c8(i)|_inf; for
    ``lazy_r1`` the bf16 cross-codebook Gram blocks; the bf16 centers (int8
    E: and the int8 ones) rearranged as the kernels' ring chunks
    (:func:`_ring_chunks`).  v1 takes the f32 squared norms of the f32
    centers and the f32 Gram of the bf16 centers (its ``q`` rows)."""
    centers = centers.float()
    cs_sumsq = (centers * centers).sum(dim=-1)  # (nc, cs)
    tables = SeqbeamTables(centers_bf16=centers.to(torch.bfloat16))
    tables.chunks_bf16 = _ring_chunks(tables.centers_bf16)
    if impl == "v1":
        cb = tables.centers_bf16.float()
        tables.cs_sumsq = cs_sumsq
        tables.q_gram = torch.bmm(cb, cb.transpose(1, 2))
        return tables
    gram = torch.bmm(centers, centers.transpose(1, 2))  # (nc, cs, cs)
    tables.gmod_bf16 = (cs_sumsq[:, None, :] - 2.0 * gram).to(torch.bfloat16)
    if e_dtype == "int8":
        amax = centers.abs().amax(dim=(1, 2))
        csc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        tables.centers_i8 = torch.round(centers / csc[:, None, None]).to(torch.int8)
        tables.csc = csc
        if requant == "bound":
            ci = tables.centers_i8.float()
            tables.cmax = (ci.amax(dim=1) - ci.amin(dim=1)).amax(dim=1)
        tables.chunks_i8 = _ring_chunks(tables.centers_i8)
    if lazy_r1:
        gx = torch.bmm(centers[:-1], centers[1:].transpose(1, 2))  # (nc-1, cs, cs)
        tables.gx_bf16 = torch.cat([torch.zeros_like(gx[:1]), gx]).to(torch.bfloat16)
    return tables


class TablesCache:
    """A kernel's codebook tables for the last ``size`` parameter versions
    and variants, so that an encode with frozen parameters builds them once.
    ``build(params, scale_speed, variant)`` makes the tables of a miss; the
    seqbeam and gramv3 kernels each keep one cache with a builder of their
    own, under this one key rule.

    An entry is keyed by the centers and their log-scale (the tensor
    objects, held weakly: an entry keeps no parameter alive and goes when
    either is freed), the scale speed and the variant (a tuple of the
    kernel's table options).  It stands while both tensors keep the version
    counters, storage, device and dtype they had at its build.  In-place
    writes bump the counters (an optimiser's step, ``copy_``,
    ``load_state_dict``); a write through ``.data``, through another
    library's view of the same memory or by a collective bumps nothing and
    is not seen.  Inference tensors keep no counter, so under
    ``torch.inference_mode`` the tables are built each call.  Every hit
    shares the entry's tables: no consumer writes into them.  The builder
    opens its kernel's ``<kernel>.tables`` span, so a build, and only a
    build, is recorded; ``hits`` and ``misses`` count the lookups."""

    def __init__(self, size: int, build):
        self.size, self.build = size, build
        self.hits = self.misses = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # reentrant: a weakref callback can run inside a locked block
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def get(self, params: QuantizerParams, scale_speed: float, *variant):
        """The tables of ``params`` for the variant, from the cache or
        built and stored."""
        c, s = params.centers, params.centers_scale
        if torch.is_inference_mode_enabled() or c.is_inference() or s.is_inference():
            return self.build(params, scale_speed, variant)
        key = (id(c), id(s), float(scale_speed), variant)
        state = (c._version, s._version, c.data_ptr(), s.data_ptr(), c.device, c.dtype, s.dtype)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0]() is c and entry[1]() is s and entry[2] == state:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[3]
            self.misses += 1
        tables = self.build(params, scale_speed, variant)
        drop = functools.partial(self._drop, key)
        with self._lock:
            self._entries[key] = (weakref.ref(c, drop), weakref.ref(s, drop), state, tables)
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        return tables

    def _drop(self, key, ref) -> None:
        """A weakref's callback: remove ``key``'s entry if ``ref`` is one of
        its references (a newer entry under the key has its own)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and (entry[0] is ref or entry[1] is ref):
                del self._entries[key]


@torch.no_grad()  # tables with a graph would keep the parameters alive
def _build_tables(params: QuantizerParams, scale_speed: float, variant) -> SeqbeamTables:
    with span("seqbeam.tables"):
        return seqbeam_tables(scaled_centers(params, scale_speed), *variant)


# 8 entries hold the four d512 variants ops/quality_guard.py runs on one
# quantizer, with room to spare; an int8 E entry at d512 is about 7 MB.
# The variant: (e_dtype, impl, requant, lazy_r1)
TABLES_CACHE = TablesCache(8, _build_tables)


@dataclasses.dataclass
class SeqbeamProblem:
    """Everything the kernels and their plain versions take: (B, D) f32
    frames, (B, nc) int32 initial indexes, the codebook tables, the beam
    shape, one pool bit word per pass (see :func:`pool_bits`), the E storage
    type, the kernel variant and v2's int8 scale rule and R1 deferral."""

    x: torch.Tensor
    idx0: torch.Tensor
    tables: SeqbeamTables
    M: int
    R: int
    passes: int
    masks: Tuple[int, ...]
    e_dtype: str
    impl: str = "v2"
    requant: str = "step"
    lazy_r1: bool = False


def _keys(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Packed selection keys as int32: the score clamped at 0 with its 8 low
    mantissa bits replaced by ``ids``.  Non-negative float bit patterns order
    like the values, so the smallest key is the smallest (truncated) score,
    lowest id on ties."""
    bits = torch.where(s > 0, s, torch.zeros_like(s)).view(torch.int32)
    return (bits & ~LANE_MASK) | ids


def _as_float(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.float32)


def _requant_rows(ef: torch.Tensor):
    """Symmetric per-row int8 requantization: (int8 values, f32 scales)."""
    s = ef.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    s = torch.clamp_min(s, 1e-20)
    return torch.round(ef * (1.0 / s)).to(torch.int8), s[..., 0]


def _clip_i8(q: torch.Tensor) -> torch.Tensor:
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def _root(x, C, sol):
    """The pass's root error -x + sum_s C_s[sol_s], in codebook order."""
    e = -x
    for s in range(C.shape[0]):
        e = e + C[s][sol[:, s]]
    return e


def _bf16_cross(e, Ct):
    """bf16(E) . bf16(C_t)^T with f32 products and sums."""
    return torch.matmul(e.to(torch.bfloat16).float(), Ct.t())


def seqbeam_plain(problem: SeqbeamProblem) -> torch.Tensor:
    """Plain PyTorch version of the seqbeam kernels: the problem's (B, D)
    f32 frames and (B, nc) initial indexes -> (B, nc) int32 indexes.  A v1
    problem goes to :func:`seqbeam_v1_plain`."""
    if problem.impl == "v1":
        return seqbeam_v1_plain(problem)
    x, idx0, tables = problem.x, problem.idx0, problem.tables
    M, R, passes, masks, e_dtype = (
        problem.M, problem.R, problem.passes, problem.masks, problem.e_dtype)
    requant, lazy = problem.requant, problem.lazy_r1
    C = tables.centers_bf16.float()  # (nc, cs, D), exact bf16 values
    G = tables.gmod_bf16.float()  # (nc, cs, cs)
    GX = tables.gx_bf16.float() if lazy else None
    nc, cs, D = C.shape
    int8 = e_dtype == "int8"
    ED = E_DTYPES[e_dtype][1]
    B = x.shape[0]
    dev = x.device
    fr = torch.arange(B, device=dev)
    lanes = torch.arange(cs, dtype=torch.int32, device=dev)
    slots = torch.arange(M, device=dev)
    mbits = (M - 1) << LANE_BITS
    sol = idx0.long().clone()  # (B, nc)

    for p in range(passes):
        # ---- root error, recomputed from the winner every pass
        e = _root(x, C, sol)
        ss0 = (e * e).sum(dim=-1)
        # ---- step 0: rescore the root, fan out to its M best children
        i0 = sol[:, 0]
        shared = G[0][i0]  # (B, cs)
        ccn = shared[fr, i0]
        cross0 = _bf16_cross(e, C[0])
        S0 = ((ss0 - 2.0 * cross0[fr, i0]) - ccn)[:, None] + shared + 2.0 * cross0
        top = torch.topk(_keys(S0, lanes), M, dim=-1, largest=False, sorted=True).values
        j = (top & LANE_MASK).long()  # (B, M)
        ss = _as_float(top & ~LANE_MASK)  # (B, M)
        chosen = sol[:, None, :].repeat(1, M, 1)
        chosen[:, :, 0] = j
        ef = e[:, None, :] + (C[0][j] - C[0][i0][:, None, :])
        if int8 and requant == "pass":
            # one scale a frame for the whole pass, from the root error
            s0 = torch.clamp_min(e.abs().amax(dim=-1) * (1.0 / 127.0), 1e-20)
            scale = s0[:, None].expand(B, M).contiguous()
            E = _clip_i8(torch.round(ef * (1.0 / s0)[:, None, None]))
        elif int8:
            E, scale = _requant_rows(ef)
        else:
            E = ef.to(ED)
        deferred = None  # (B, M) j of a deferring R1 step, by slot
        # ---- steps 1..nc-1
        for t in range(1, nc):
            pool = bool((masks[p] >> t) & 1)
            last = t == nc - 1
            pending, deferred = deferred, None
            it = sol[:, t]
            shared = G[t][it]
            ccn = shared[fr, it]
            if int8:
                csc_t = tables.csc[t]
                counts = torch.matmul(E.float(), tables.centers_i8[t].float().t())
                cross = counts * (scale * csc_t)[..., None]
            else:
                cross = _bf16_cross(E, C[t])  # (B, M, cs)
            if pending is not None:
                # the E rows still lack codebook t-1's deferred delta
                ip = sol[:, t - 1]
                cross = cross + (GX[t][pending] - GX[t][ip][:, None, :])
            Ec = torch.gather(cross, 2, it[:, None, None].expand(B, M, 1))[..., 0]
            S = ((ss - 2.0 * Ec) - ccn[:, None])[..., None] + shared[:, None, :] + 2.0 * cross
            keys = _keys(S, lanes)
            if not pool:
                w = keys.min(dim=-1).values  # (B, M)
                parent = slots.expand(B, M)
            else:
                rk = torch.topk(keys, R, dim=-1, largest=False, sorted=True).values
                pk = (rk & ~mbits) | (slots.to(torch.int32) << LANE_BITS)[None, :, None]
                w = torch.topk(pk.reshape(B, M * R), M, dim=-1, largest=False,
                               sorted=True).values
                parent = ((w >> LANE_BITS) & (M - 1)).long()
                chosen = torch.gather(chosen, 1, parent[..., None].expand(B, M, nc))
            j = (w & LANE_MASK).long()
            ss = _as_float(w & ~(mbits | LANE_MASK) if pool else w & ~LANE_MASK)
            chosen[:, :, t] = j
            if last:
                continue
            if lazy and not pool:
                deferred = j
                continue
            src = torch.gather(E, 1, parent[..., None].expand(B, M, D)) if pool else E
            jp = torch.gather(pending, 1, parent) if pending is not None else None
            if int8:
                s_par = torch.gather(scale, 1, parent) if pool else scale
                ci8 = tables.centers_i8[t]
                cdi = (ci8[j].int() - ci8[it][:, None, :].int()).float()
                if requant == "pass":
                    col = csc_t * (1.0 / s_par)
                    E = _clip_i8(src.float() + torch.round(cdi * col[..., None]))
                    scale = s_par
                    continue
                inv_csc = torch.ones_like(csc_t) / csc_t
                s_adj = s_par * inv_csc
                ef = src.float() * s_adj[..., None] + cdi
                if jp is not None:
                    # the deferred delta in csc[t-1] units, rescaled to csc[t]
                    cp8 = tables.centers_i8[t - 1]
                    cdp = (cp8[jp].int() - cp8[ip][:, None, :].int()).float()
                    ef = ef + cdp * (tables.csc[t - 1] * inv_csc)
                if requant == "bound":
                    s_u = s_adj + tables.cmax[t] * (1.0 / 127.0)
                    E = _clip_i8(torch.round(ef * (1.0 / s_u)[..., None]))
                else:
                    E, s_u = _requant_rows(ef)
                scale = s_u * csc_t
            else:
                delta = C[t][j] - C[t][it][:, None, :]
                if jp is not None:
                    delta = delta + (C[t - 1][jp] - C[t - 1][ip][:, None, :])
                E = (src.float() + delta).to(ED)
        # ---- pass end: the smallest packed (ss, m) becomes the root
        best = torch.argmin(_keys(ss, slots.to(torch.int32)), dim=-1)
        sol = chosen[fr, best]
    return sol.to(torch.int32)


def seqbeam_v1_plain(problem: SeqbeamProblem) -> torch.Tensor:
    """Plain PyTorch version of the v1 kernel (f32 E, all-pool steps): the
    problem's (B, D) f32 frames and (B, nc) initial indexes -> (B, nc)
    int32 indexes."""
    x, idx0, tables = problem.x, problem.idx0, problem.tables
    M, R, passes = problem.M, problem.R, problem.passes
    C = tables.centers_bf16.float()  # (nc, cs, D), exact bf16 values
    Q, csq = tables.q_gram, tables.cs_sumsq
    nc, cs, D = C.shape
    B = x.shape[0]
    dev = x.device
    fr = torch.arange(B, device=dev)
    lanes = torch.arange(cs, dtype=torch.int32, device=dev)
    slots = torch.arange(M, device=dev)
    pool_lanes = torch.arange(M * R, dtype=torch.int32, device=dev)
    sol = idx0.long().clone()  # (B, nc)

    for p in range(passes):
        e = _root(x, C, sol)
        ss = (e * e).sum(dim=-1)[:, None]  # (B, 1): the root only
        E = e[:, None, :]
        chosen = sol[:, None, :]
        for t in range(nc):
            it = sol[:, t]
            q = Q[t][it]  # (B, cs)
            cc = q[fr, it]
            cross = _bf16_cross(E, C[t])  # (B, rows, cs)
            Ec = torch.gather(cross, 2, it[:, None, None].expand(B, E.shape[1], 1))[..., 0]
            S = (((ss - 2.0 * Ec) + cc[:, None])[..., None] + csq[t]) + 2.0 * (cross - q[:, None, :])
            keys = _keys(S, lanes)
            if t == 0:
                # the root fans out to its M best children
                w = torch.topk(keys[:, 0], M, dim=-1, largest=False, sorted=True).values
                parent = torch.zeros(B, M, dtype=torch.long, device=dev)
                j = (w & LANE_MASK).long()
            else:
                # top R per parent, repacked with the pool lane m R + r
                rk = torch.topk(keys, R, dim=-1, largest=False, sorted=True).values
                pk = (rk & ~LANE_MASK).reshape(B, M * R) | pool_lanes
                w = torch.topk(pk, M, dim=-1, largest=False, sorted=True).values
                pos = (w & LANE_MASK).long()
                parent = torch.div(pos, R, rounding_mode="floor")
                j = (torch.gather(rk.reshape(B, M * R), 1, pos) & LANE_MASK).long()
            ss = _as_float(w & ~LANE_MASK)
            chosen = torch.gather(chosen, 1, parent[..., None].expand(B, M, nc)).clone()
            chosen[:, :, t] = j
            if t < nc - 1:
                src = torch.gather(E, 1, parent[..., None].expand(B, M, D))
                E = src + (C[t][j] - C[t][it][:, None, :])
        best = torch.argmin(_keys(ss, slots.to(torch.int32)), dim=-1)
        sol = chosen[fr, best]
    return sol.to(torch.int32)


def _on_device(x: torch.Tensor, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError("seqbeam_cuda needs all tensors on one device")


def seqbeam_cuda(problem: SeqbeamProblem) -> torch.Tensor:
    """The CUDA kernel on the same problem as :func:`seqbeam_plain`: v2
    through ``qtt_seqbeam_v2_launch``, v1 through ``qtt_seqbeam_v1_launch``
    (counted apart)."""
    return _launch(problem, SEQBEAM_V1_KERNEL if problem.impl == "v1" else SEQBEAM_KERNEL)


def seqbeam_stages(problem: SeqbeamProblem) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage-timed build of the kernel on the same problem as
    :func:`seqbeam_cuda`: the same (B, nc) indexes, and a (blocks,
    len(STAGES) + 2) int64 tensor holding, per block of frames, the
    ``clock64()`` cycles of each of :data:`STAGES` summed over the block's
    warps, then the block's own cycles and nanoseconds.  Built only for the
    auto ladder's rungs (v2, M=8, ``requant="step"``, no ``lazy_r1``, bf16 or
    int8 E) and for v1 at the JAX wrapper's defaults (M=16, R=8); CUDA
    tensors only."""
    if problem.impl == "v1":
        if problem.M != 16 or problem.R != 8:
            raise ValueError("the stage-timed seqbeam v1 takes M=16 and R=8")
        kernel = SEQBEAM_V1_TIMED_KERNEL
    elif problem.M != 8 or problem.requant != "step" or (
            problem.lazy_r1 or problem.e_dtype == "f32"):
        raise ValueError("the stage-timed seqbeam v2 takes M=8, requant='step', no lazy_r1 and "
                         "bf16 or int8 E")
    else:
        kernel = SEQBEAM_TIMED_KERNEL
    if not problem.x.is_cuda:
        raise ValueError("seqbeam_stages needs CUDA tensors")
    blocks = -(-problem.x.shape[0] // seqbeam_layout(problem)["frames"])
    stages = torch.zeros(blocks, len(STAGES) + 2, dtype=torch.int64, device=problem.x.device)
    return _launch(problem, kernel, stages.data_ptr()), stages


def _check_wide(problem: SeqbeamProblem, D: int) -> None:
    """Above :data:`NARROW_DIM` the kernel runs v2 with bf16 or int8 E,
    M=8, ``requant="step"`` and no ``lazy_r1`` (auto's rungs) and nothing
    else: raise ValueError for any other beam there."""
    if D > NARROW_DIM and not (
            problem.impl == "v2" and problem.e_dtype in ("bf16", "int8") and problem.M == 8
            and problem.requant == "step" and not problem.lazy_r1):
        raise ValueError(
            f"above dim {NARROW_DIM} the seqbeam kernel runs v2 with bf16 or int8 E, M=8, "
            f"requant='step' and no lazy_r1 only; got {problem.impl} with {problem.e_dtype} E, "
            f"M={problem.M}, requant={problem.requant!r}, lazy_r1={problem.lazy_r1} at dim {D}")


def seqbeam_layout(problem: SeqbeamProblem) -> dict:
    """The kernel's shared-memory layout on ``problem``: frames a block,
    its kind ("full"; "compact", the ring in the score tile's space;
    "spill", E in a global scratch slot), its shared-memory bytes and the
    bytes of a block's scratch slot (0 unless it spills).  Every beam the
    JAX wrapper takes has one up to dim 1024; above it, auto's beams only
    (:func:`_check_wide`)."""
    nc, _, D = problem.tables.centers_bf16.shape
    _check_wide(problem, D)
    out = (ctypes.c_longlong * 4)()
    LAYOUT(E_DTYPES[problem.e_dtype][0], problem.M, D, nc, problem.R, int(problem.lazy_r1),
           ctypes.addressof(out))
    F, kind, smem, spill = out
    if F == 0:
        raise ValueError(f"seqbeam {problem.impl} with {problem.e_dtype} E, M={problem.M}, "
                         f"R={problem.R} at dim {D} has no layout on the card")
    return {"frames": F, "kind": LAYOUT_KINDS[kind], "smem_bytes": smem, "spill_bytes": spill}


def _spill_scratch(layout: dict, device: torch.device):
    """The spill layout's scratch: a slot for each block that can be
    resident at once (by shared memory; a block that finds every slot
    taken waits for one), and their zeroed claim flags."""
    if not layout["spill_bytes"]:
        return None, None, 0
    per_sm = max(1, min(8, SM_SHARED_BYTES // (layout["smem_bytes"] + 1024)))
    nslots = torch.cuda.get_device_properties(device).multi_processor_count * per_sm
    spill = torch.empty(nslots * layout["spill_bytes"], dtype=torch.uint8, device=device)
    return spill, torch.zeros(nslots, dtype=torch.int32, device=device), nslots


def _launch(problem: SeqbeamProblem, kernel: CudaKernel, *extra) -> torch.Tensor:
    """Check the problem's tensors and launch ``kernel`` (v1's entry point
    or one of v2's, by ``problem.impl``) on them with ``extra`` arguments
    before the stream; returns the (B, nc) indexes."""
    with span("seqbeam.launch") as sp:
        x, idx0, tables = problem.x, problem.idx0, problem.tables
        M, R, passes, masks, e_dtype = (
            problem.M, problem.R, problem.passes, problem.masks, problem.e_dtype)
        nc, cs, D = tables.centers_bf16.shape
        B = x.shape[0]
        if not x.is_cuda:
            raise ValueError("seqbeam_cuda needs CUDA tensors")
        if x.dtype != torch.float32 or x.shape != (B, D):
            raise ValueError(f"expected (B, {D}) float32 frames, got {x.dtype} {tuple(x.shape)}")
        if idx0.shape != (B, nc) or len(masks) != passes:
            raise ValueError(f"expected ({B}, {nc}) initial indexes and {passes} pool masks, "
                             f"got {tuple(idx0.shape)} and {len(masks)}")
        layout = seqbeam_layout(problem)
        sp.set(layout=layout["kind"], chunks=D // 128, smem_bytes=layout["smem_bytes"])
        spill, slots, nslots = _spill_scratch(layout, x.device)
        x = x.contiguous()
        idx0 = idx0.to(torch.int32).contiguous()
        centers = tables.centers_bf16.contiguous()
        if centers.dtype != torch.bfloat16:
            raise TypeError("seqbeam tables must hold bf16 centers")
        out = torch.empty(B, nc, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # the kernels stream the codebooks through their rings of chunks
        cpb = tables.chunks_bf16
        if cpb is None or (e_dtype == "int8" and tables.chunks_i8 is None):
            raise TypeError("seqbeam tables must hold the ring chunks")
        if problem.impl == "v1":
            qg = tables.q_gram.float().contiguous()
            csq = tables.cs_sumsq.float().contiguous()
            _on_device(x, idx0, centers, qg, csq, cpb)
            kernel(x.data_ptr(), idx0.data_ptr(), centers.data_ptr(), qg.data_ptr(), csq.data_ptr(),
                   cpb.data_ptr(), out.data_ptr(), B, D, nc, M, R, passes, _ptr(spill), _ptr(slots),
                   nslots, *extra, stream)
            LAYOUT_LAUNCHES[layout["kind"]] += 1
            return out
        int8 = e_dtype == "int8"
        gmod = tables.gmod_bf16.contiguous()
        ci8 = tables.centers_i8.contiguous() if int8 else None
        csc = tables.csc.float().contiguous() if int8 else None
        cmax = tables.cmax.float().contiguous() if problem.requant == "bound" else None
        gx = tables.gx_bf16.contiguous() if problem.lazy_r1 else None
        if gmod.dtype != torch.bfloat16 or (int8 and ci8.dtype != torch.int8) or (
                gx is not None and gx.dtype != torch.bfloat16):
            raise TypeError("seqbeam tables must be bf16 Gram blocks (int8 centers)")
        cpi = tables.chunks_i8 if int8 else None
        _on_device(x, idx0, centers, gmod, ci8, csc, cmax, gx, cpb, cpi)
        words = (ctypes.c_uint32 * max(passes, 1))(*masks)
        kernel(
            x.data_ptr(), idx0.data_ptr(), centers.data_ptr(), gmod.data_ptr(), _ptr(ci8),
            _ptr(csc), _ptr(cmax), _ptr(gx), _ptr(cpb), _ptr(cpi), out.data_ptr(), B, D, nc, M,
            R, passes, ctypes.addressof(words), E_DTYPES[e_dtype][0], REQUANTS[problem.requant],
            int(problem.lazy_r1), _ptr(spill), _ptr(slots), nslots, *extra, stream,
        )
        LAYOUT_LAUNCHES[layout["kind"]] += 1
        return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _ring_chunks(c: torch.Tensor) -> torch.Tensor:
    """(nc, 256, D) bf16 or int8 codebooks as the kernels' ring chunks: per
    codebook, one chunk per 128 bytes of a row, each [8 16-byte K
    pieces][256 codewords][16 bytes], the layout wgmma's B operand reads.  A
    chunk is one contiguous 32 KB copy.  The f32-E kernels stream the bf16
    chunks through a ring of their own."""
    nc, cs, _ = c.shape
    b = c.contiguous().view(torch.uint8).reshape(nc, cs, -1, 8, 16)
    return b.permute(0, 2, 3, 1, 4).contiguous()


def init_indexes_from_logits(
    params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor,
    init_precision: str = "highest",
) -> torch.Tensor:
    """argmax of the prediction logits: in full f32 ("highest"), or with
    bf16-rounded operands and f32 sums ("default", the single-pass matmul
    of the TPU); lowest index on ties."""
    if init_precision == "highest":
        logits = _search.compute_logits(params, config, x)
    elif init_precision == "default":
        scale = torch.exp(params.logits_scale * config.scale_speed)
        a = (scale * x).to(torch.bfloat16).float()
        w = params.to_logits_w.to(torch.bfloat16).float()
        logits = (torch.matmul(a, w.t()) + params.to_logits_b).reshape(
            x.shape[0], config.num_codebooks, config.codebook_size)
    else:
        raise ValueError(f"unknown init_precision {init_precision!r}")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def seqbeam_encode_indexes(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    M: int = 16,
    R: int = 8,
    passes: int = 3,
    block_b: int = 128,
    init_indexes: Optional[torch.Tensor] = None,
    impl: str = "v2",
    interleave: int = 1,
    pool_mask=None,
    cross_value: bool = False,
    reorder: str = "gather",
    e_dtype: str = "f32",
    requant: str = "step",
    zip_skew: int = 0,
    init_precision: str = "highest",
    sel_impl: str = "lohi",
    lazy_r1: bool = False,
) -> torch.Tensor:
    """Encode (B, dim) frames to (B, nc) int32 indexes with the sequential
    beam: the kernel on a CUDA tensor, its plain version on a CPU tensor.
    Initialisation is the logits argmax, or the caller's ``init_indexes``
    (e.g. a coordinate-descent warm start).

    ``block_b``, ``interleave``, ``zip_skew``, ``cross_value``, ``reorder``
    and ``sel_impl`` are the TPU kernel's scheduling knobs; they do not
    change results and are ignored, but a combination the TPU wrapper
    refuses is refused here too (:func:`_check_knobs`).
    Raises ValueError for a combination the TPU kernels do not take."""
    problem = seqbeam_problem(
        params, config, x, M, R, passes, pool_mask, e_dtype, init_indexes, init_precision,
        impl=impl, requant=requant, lazy_r1=lazy_r1)
    _check_knobs(impl, e_dtype, lazy_r1, pool_mask, block_b, interleave, zip_skew, cross_value,
                 reorder, sel_impl)
    return dispatch("seqbeam", x.device, seqbeam_cuda, seqbeam_plain, problem)


def _check_knobs(impl: str, e_dtype: str, lazy_r1: bool, pool_mask, block_b: int,
                 interleave: int, zip_skew: int, cross_value: bool, reorder: str,
                 sel_impl: str) -> None:
    """Raise ValueError where the TPU wrapper asserts on its scheduling
    knobs (``quantization_tpu/ops/seqbeam.py:1710-1776``): v1 takes a tile
    of at most 128 frames, ``zip_skew=0`` and ``sel_impl="lohi"``;
    ``zip_skew`` needs an interleave that splits ``block_b`` into sub-tiles
    of 64-512 frames and a static ``pool_mask``; bf16 and int8 E need a
    select reorder, and int8 E and ``lazy_r1`` ``reorder="select"`` without
    ``cross_value``."""
    if impl == "v1":
        if block_b > 128 or zip_skew != 0 or sel_impl != "lohi":
            raise ValueError("seqbeam impl='v1' takes block_b <= 128, zip_skew=0 and "
                             f"sel_impl='lohi', got {block_b}, {zip_skew}, {sel_impl!r}")
        return
    subt = interleave if block_b % interleave == 0 else 1
    if block_b // subt not in (64, 128, 256, 512):
        subt = 1
    if zip_skew and (subt == 1 or pool_mask is None):
        raise ValueError(f"zip_skew needs interleave >= 2 splitting block_b={block_b} into "
                         f"sub-tiles of 64-512 frames and a static pool_mask, got "
                         f"interleave={interleave}, pool_mask={pool_mask!r}")
    if e_dtype != "f32" and reorder not in ("select", "wideselect"):
        raise ValueError(f"e_dtype={e_dtype!r} needs reorder='select' or 'wideselect', "
                         f"got {reorder!r}")
    if (e_dtype == "int8" or lazy_r1) and (reorder != "select" or cross_value):
        raise ValueError("int8 E and lazy_r1 need reorder='select' and cross_value=False, "
                         f"got {reorder!r}, cross_value={cross_value}")


def _check_variant(M: int, R: int, nc: int, passes: int, pool_mask, e_dtype: str, impl: str,
                   requant: str, lazy_r1: bool) -> None:
    """Raise ValueError for what the TPU wrapper and kernels refuse."""
    if e_dtype not in E_DTYPES:
        raise ValueError(f"unknown e_dtype {e_dtype!r}")
    if requant not in REQUANTS:
        raise ValueError(f"unknown requant {requant!r}")
    if impl == "v1":
        if e_dtype != "f32" or requant != "step" or lazy_r1 or pool_mask is not None:
            raise ValueError("seqbeam impl='v1' takes f32 E, requant='step', no lazy_r1 and "
                             "no pool_mask")
        if M % 8 or not 8 <= M <= 64 or R < 1 or M * R > 1 << LANE_BITS:
            raise ValueError(f"seqbeam v1 needs M a multiple of 8 in [8, 64] and "
                             f"M*R <= 256, got M={M}, R={R}")
        return
    if impl != "v2":
        raise ValueError(f"unknown seqbeam impl {impl!r}")
    if M not in (8, 16, 32, 64) or R < 1 or M * R > 512:
        raise ValueError(f"seqbeam needs M in (8, 16, 32, 64) and M*R <= 512, got M={M}, R={R}")
    if requant != "step" and e_dtype != "int8":
        raise ValueError(f"requant={requant!r} needs e_dtype='int8'")
    if lazy_r1:
        if pool_mask is None or requant != "step":
            raise ValueError("lazy_r1 needs a static pool_mask and requant='step'")
        for m in _normalize_pool_mask(pool_mask, nc, passes):
            if any(not (m[t] or m[t + 1]) for t in range(1, nc - 1)):
                raise ValueError(f"lazy_r1: a deferring R1 step must be followed by a pool "
                                 f"step, got {m}")


@torch.no_grad()
def seqbeam_problem(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    M: int,
    R: int,
    passes: int,
    pool_mask=None,
    e_dtype: str = "f32",
    init_indexes: Optional[torch.Tensor] = None,
    init_precision: str = "highest",
    impl: str = "v2",
    requant: str = "step",
    lazy_r1: bool = False,
) -> SeqbeamProblem:
    """The kernel's inputs for (B, dim) frames ``x``, on ``x``'s device:
    the initial indexes (the logits argmax unless ``init_indexes`` is
    given), the codebook tables (:data:`TABLES_CACHE`'s) and the per-pass
    pool schedule.  Raises ValueError for a config, beam shape or variant
    the kernels do not take."""
    if not SEQBEAM_SUPPORTED(config):
        raise ValueError(f"seqbeam does not support {config}")
    if not 1 <= passes <= MAX_PASSES:
        raise ValueError(f"passes must be in [1, {MAX_PASSES}], got {passes}")
    _check_variant(M, R, config.num_codebooks, passes, pool_mask, e_dtype, impl, requant,
                   lazy_r1)
    x = x.float().contiguous()
    with span("seqbeam.init"):
        if init_indexes is None:
            idx0 = init_indexes_from_logits(params, config, x, init_precision)
        else:
            idx0 = init_indexes.to(device=x.device, dtype=torch.int32)
            if idx0.shape != (x.shape[0], config.num_codebooks) or bool(
                    ((idx0 < 0) | (idx0 >= config.codebook_size)).any()):
                raise ValueError(
                    "init_indexes must be (B, nc) codeword ids in [0, codebook_size)")
    tables = TABLES_CACHE.get(params, config.scale_speed, e_dtype, impl, requant, bool(lazy_r1))
    masks = pool_bits(pool_mask, config.num_codebooks, passes)
    return SeqbeamProblem(x, idx0.contiguous(), tables, M, R, passes, masks, e_dtype, impl,
                          requant, bool(lazy_r1))
