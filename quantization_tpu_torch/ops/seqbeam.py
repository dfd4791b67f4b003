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

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..core.types import QuantizerConfig, QuantizerParams
from ..utils.device import dispatch
from ..utils.spans import span
from . import cuda_build
from .beam_common import (LANE_BITS, LANE_MASK, MAX_PASSES, SearchKernel, as_float,
                          initial_indexes, normalize_pool_mask, on_one_device, packed_keys,
                          pool_bits)
from .cuda_build import CudaKernel
from .tables_cache import TablesCache

E_DTYPES = {"f32": (0, torch.float32), "bf16": (1, torch.bfloat16), "int8": (2, torch.int8)}
REQUANTS = {"step": 0, "pass": 1, "bound": 2}
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


@dataclasses.dataclass
class SeqbeamTables:
    """The kernel's codebook inputs, prepared from the scaled centers; each
    optional table is made only for the variant that reads it; their types
    are checked here (TypeError), once a parameter version, not at a launch."""

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

    def __post_init__(self):
        if self.chunks_bf16 is None or (self.centers_i8 is not None and self.chunks_i8 is None):
            raise TypeError("seqbeam tables must hold the ring chunks")
        bf16, f32 = torch.bfloat16, torch.float32
        for f, want in dict(centers_bf16=bf16, gmod_bf16=bf16, gx_bf16=bf16, centers_i8=torch.int8,
                            csc=f32, cmax=f32, cs_sumsq=f32, q_gram=f32).items():
            if getattr(self, f) is not None and getattr(self, f).dtype != want:
                raise TypeError(f"seqbeam tables must hold {f} in {want}")
        if not all(t is None or t.is_contiguous()
                   for t in (getattr(self, f.name) for f in dataclasses.fields(self))):
            raise TypeError("seqbeam tables must be contiguous")


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
    centers = centers.float().contiguous()
    cs_sumsq = (centers * centers).sum(dim=-1)  # (nc, cs)
    cb = centers.to(torch.bfloat16)
    t = dict(centers_bf16=cb, chunks_bf16=_ring_chunks(cb))
    if impl == "v1":
        cbf = cb.float()
        return SeqbeamTables(**t, cs_sumsq=cs_sumsq, q_gram=torch.bmm(cbf, cbf.transpose(1, 2)))
    gram = torch.bmm(centers, centers.transpose(1, 2))  # (nc, cs, cs)
    t["gmod_bf16"] = (cs_sumsq[:, None, :] - 2.0 * gram).to(torch.bfloat16)
    if e_dtype == "int8":
        amax = centers.abs().amax(dim=(1, 2))
        t["csc"] = csc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        t["centers_i8"] = ci8 = torch.round(centers / csc[:, None, None]).to(torch.int8)
        if requant == "bound":
            ci = ci8.float()
            t["cmax"] = (ci.amax(dim=1) - ci.amin(dim=1)).amax(dim=1)
        t["chunks_i8"] = _ring_chunks(ci8)
    if lazy_r1:
        gx = torch.bmm(centers[:-1], centers[1:].transpose(1, 2))  # (nc-1, cs, cs)
        t["gx_bf16"] = torch.cat([torch.zeros_like(gx[:1]), gx]).to(torch.bfloat16)
    return SeqbeamTables(**t)


# 8 entries hold the four d512 variants ops/quality_guard.py runs on one
# quantizer, with room to spare; an int8 E entry at d512 is about 7 MB.
# The variant: (e_dtype, impl, requant, lazy_r1)
TABLES_CACHE = TablesCache(8, "seqbeam", seqbeam_tables)


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

    @property
    def kernel(self) -> SearchKernel:
        return SEQBEAM


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
        top = torch.topk(packed_keys(S0, lanes), M, dim=-1, largest=False, sorted=True).values
        j = (top & LANE_MASK).long()  # (B, M)
        ss = as_float(top & ~LANE_MASK)  # (B, M)
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
            keys = packed_keys(S, lanes)
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
            ss = as_float(w & ~(mbits | LANE_MASK) if pool else w & ~LANE_MASK)
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
        best = torch.argmin(packed_keys(ss, slots.to(torch.int32)), dim=-1)
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
            keys = packed_keys(S, lanes)
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
            ss = as_float(w & ~LANE_MASK)
            chosen = torch.gather(chosen, 1, parent[..., None].expand(B, M, nc)).clone()
            chosen[:, :, t] = j
            if t < nc - 1:
                src = torch.gather(E, 1, parent[..., None].expand(B, M, D))
                E = src + (C[t][j] - C[t][it][:, None, :])
        best = torch.argmin(packed_keys(ss, slots.to(torch.int32)), dim=-1)
        sol = chosen[fr, best]
    return sol.to(torch.int32)


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
    """Check the call's frames and initial indexes and launch ``kernel`` (v1's
    entry point or one of v2's, by ``problem.impl``) on them and the tables
    with ``extra`` arguments before the stream; returns the (B, nc) indexes."""
    with span("seqbeam.launch") as sp:
        x, idx0, tables = problem.x, problem.idx0, problem.tables
        M, R, passes, masks, e_dtype = (
            problem.M, problem.R, problem.passes, problem.masks, problem.e_dtype)
        nc, cs, D = tables.centers_bf16.shape
        B = x.shape[0]
        if not x.is_cuda:
            raise ValueError("seqbeam_cuda needs CUDA tensors")
        if x.dtype != torch.float32 or x.shape != (B, D) or not x.is_contiguous():
            raise ValueError(f"expected (B, {D}) float32 frames, got {x.dtype} {tuple(x.shape)}")
        if idx0.shape != (B, nc) or idx0.dtype != torch.int32 or len(masks) != passes:
            raise ValueError(f"expected ({B}, {nc}) int32 initial indexes and {passes} pool masks, "
                             f"got {idx0.dtype} {tuple(idx0.shape)} and {len(masks)}")
        layout = seqbeam_layout(problem)
        sp.set(layout=layout["kind"], chunks=D // 128, smem_bytes=layout["smem_bytes"])
        spill, slots, nslots = _spill_scratch(layout, x.device)
        centers, cpb = tables.centers_bf16, tables.chunks_bf16
        out = torch.empty(B, nc, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if problem.impl == "v1":
            qg, csq = tables.q_gram, tables.cs_sumsq
            on_one_device("seqbeam_cuda", x, idx0, centers, qg, csq, cpb)
            kernel(x.data_ptr(), idx0.data_ptr(), centers.data_ptr(), qg.data_ptr(), csq.data_ptr(),
                   cpb.data_ptr(), out.data_ptr(), B, D, nc, M, R, passes, _ptr(spill), _ptr(slots),
                   nslots, *extra, stream)
            return out
        int8 = e_dtype == "int8"
        gmod = tables.gmod_bf16
        ci8, csc, cpi = (tables.centers_i8, tables.csc, tables.chunks_i8) if int8 else (None,) * 3
        cmax = tables.cmax if problem.requant == "bound" else None
        gx = tables.gx_bf16 if problem.lazy_r1 else None
        on_one_device("seqbeam_cuda", x, idx0, centers, gmod, ci8, csc, cmax, gx, cpb, cpi)
        words = (ctypes.c_uint32 * max(passes, 1))(*masks)
        kernel(
            x.data_ptr(), idx0.data_ptr(), centers.data_ptr(), gmod.data_ptr(), _ptr(ci8),
            _ptr(csc), _ptr(cmax), _ptr(gx), _ptr(cpb), _ptr(cpi), out.data_ptr(), B, D, nc, M,
            R, passes, ctypes.addressof(words), E_DTYPES[e_dtype][0], REQUANTS[problem.requant],
            int(problem.lazy_r1), _ptr(spill), _ptr(slots), nslots, *extra, stream,
        )
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
        for m in normalize_pool_mask(pool_mask, nc, passes):
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
        idx0 = initial_indexes(params, config, x, init_indexes, init_precision)
    tables = TABLES_CACHE.get(params, config.scale_speed, e_dtype, impl, requant, bool(lazy_r1))
    masks = pool_bits(pool_mask, config.num_codebooks, passes)
    return SeqbeamProblem(x, idx0, tables, M, R, passes, masks, e_dtype, impl, requant,
                          bool(lazy_r1))


SEQBEAM = SearchKernel(
    "seqbeam", SEQBEAM_SUPPORTED, seqbeam_problem, seqbeam_cuda, seqbeam_plain, SEQBEAM_KERNEL,
    TABLES_CACHE, lambda *a, **kw: seqbeam_encode_indexes(*a, **kw))
