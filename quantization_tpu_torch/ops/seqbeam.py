"""Fused sequential-beam encode (seqbeam v2).

Counterpart of ``quantization_tpu/ops/seqbeam.py::seqbeam_encode_indexes``
with ``impl="v2"``.  An M-wide beam sweeps the codebooks in order for
``passes`` passes; at each codebook every candidate is rescored against all
256 codewords and the beam is re-selected.  The CUDA kernel
(``csrc/seqbeam.cu``) keeps a tile of frames' candidate errors, scores and
beam bookkeeping in shared memory for all passes; :func:`seqbeam_plain` is
the same function in plain PyTorch, step for step, and is what a CPU tensor
runs.

Semantics carried over from the TPU kernel, each of which changes results:

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
  (``s = max(max|e| / 127, 1e-20)``, round half to even);
* the pass ends on the candidate with the smallest packed (ss, m).

The Mosaic scheduling knobs of the TPU wrapper (``interleave``,
``zip_skew``, ``cross_value``, ``reorder``, ``sel_impl``, ``block_b``) give
bit-identical results there by contract, and are accepted and ignored here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..core import search as _search
from ..core.types import QuantizerConfig, QuantizerParams, scaled_centers
from .cuda_build import CudaKernel

LANE_BITS = 8
LANE_MASK = (1 << LANE_BITS) - 1
E_DTYPES = {"f32": (0, torch.float32), "bf16": (1, torch.bfloat16), "int8": (2, torch.int8)}
MAX_PASSES = 64

SEQBEAM_KERNEL = CudaKernel(
    "seqbeam", "qtt_seqbeam_v2_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_void_p],
)


def SEQBEAM_SUPPORTED(config: QuantizerConfig) -> bool:
    """Kernel constraints: flagship-family configs only; everything else
    falls back to the pair-tree beam."""
    return (
        config.codebook_size == 256
        and config.dim % 128 == 0
        and 128 <= config.dim <= 1024
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
    """The kernel's codebook inputs, prepared from the scaled centers."""

    centers_bf16: torch.Tensor  # (nc, cs, D) bf16
    gmod_bf16: torch.Tensor  # (nc, cs, cs) bf16: csq[t, j] - 2 c_t(i).c_t(j)
    centers_i8: Optional[torch.Tensor] = None  # (nc, cs, D) int8, units of csc
    csc: Optional[torch.Tensor] = None  # (nc,) f32 per-codebook int8 scales


def seqbeam_tables(centers: torch.Tensor, int8: bool) -> SeqbeamTables:
    """Tables from (nc, cs, D) f32 scaled centers: bf16 centers, the bf16
    modified Gram blocks (computed in f32) and, for int8 E, the per-codebook
    symmetric int8 centers with scale ``amax / 127``."""
    centers = centers.float()
    cs_sumsq = (centers * centers).sum(dim=-1)  # (nc, cs)
    gram = torch.bmm(centers, centers.transpose(1, 2))  # (nc, cs, cs)
    tables = SeqbeamTables(
        centers_bf16=centers.to(torch.bfloat16),
        gmod_bf16=(cs_sumsq[:, None, :] - 2.0 * gram).to(torch.bfloat16),
    )
    if int8:
        amax = centers.abs().amax(dim=(1, 2))
        csc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        tables.centers_i8 = torch.round(centers / csc[:, None, None]).to(torch.int8)
        tables.csc = csc
    return tables


@dataclasses.dataclass
class SeqbeamProblem:
    """Everything the kernel and its plain version take: (B, D) f32 frames,
    (B, nc) int32 initial indexes, the codebook tables, the beam shape, one
    pool bit word per pass (see :func:`pool_bits`) and the E storage type."""

    x: torch.Tensor
    idx0: torch.Tensor
    tables: SeqbeamTables
    M: int
    R: int
    passes: int
    masks: Tuple[int, ...]
    e_dtype: str


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


def seqbeam_plain(problem: SeqbeamProblem) -> torch.Tensor:
    """Plain PyTorch version of the seqbeam v2 kernel: the problem's (B, D)
    f32 frames and (B, nc) initial indexes -> (B, nc) int32 indexes."""
    x, idx0, tables = problem.x, problem.idx0, problem.tables
    M, R, passes, masks, e_dtype = (
        problem.M, problem.R, problem.passes, problem.masks, problem.e_dtype)
    C = tables.centers_bf16.float()  # (nc, cs, D), exact bf16 values
    G = tables.gmod_bf16.float()  # (nc, cs, cs)
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

    def bf16_cross(e, t):  # bf16(E) . bf16(C_t)^T, f32 products and sums
        return torch.matmul(e.to(torch.bfloat16).float(), C[t].t())

    for p in range(passes):
        # ---- root error, recomputed from the winner every pass
        e = -x
        for s in range(nc):
            e = e + C[s][sol[:, s]]
        ss0 = (e * e).sum(dim=-1)
        # ---- step 0: rescore the root, fan out to its M best children
        i0 = sol[:, 0]
        shared = G[0][i0]  # (B, cs)
        ccn = shared[fr, i0]
        cross0 = bf16_cross(e, 0)
        S0 = ((ss0 - 2.0 * cross0[fr, i0]) - ccn)[:, None] + shared + 2.0 * cross0
        top = torch.topk(_keys(S0, lanes), M, dim=-1, largest=False, sorted=True).values
        j = (top & LANE_MASK).long()  # (B, M)
        ss = _as_float(top & ~LANE_MASK)  # (B, M)
        chosen = sol[:, None, :].repeat(1, M, 1)
        chosen[:, :, 0] = j
        ef = e[:, None, :] + (C[0][j] - C[0][i0][:, None, :])
        if int8:
            E, scale = _requant_rows(ef)
        else:
            E = ef.to(ED)
        # ---- steps 1..nc-1
        for t in range(1, nc):
            pool = bool((masks[p] >> t) & 1)
            last = t == nc - 1
            it = sol[:, t]
            shared = G[t][it]
            ccn = shared[fr, it]
            if int8:
                csc_t = tables.csc[t]
                counts = torch.matmul(E.float(), tables.centers_i8[t].float().t())
                cross = counts * (scale * csc_t)[..., None]
            else:
                cross = bf16_cross(E, t)  # (B, M, cs)
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
            src = torch.gather(E, 1, parent[..., None].expand(B, M, D)) if pool else E
            if int8:
                s_par = torch.gather(scale, 1, parent) if pool else scale
                inv_csc = torch.ones_like(csc_t) / csc_t
                ci8 = tables.centers_i8[t]
                cdi = (ci8[j].int() - ci8[it][:, None, :].int()).float()
                ef = src.float() * (s_par * inv_csc)[..., None] + cdi
                E, s_u = _requant_rows(ef)
                scale = s_u * csc_t
            else:
                E = (src.float() + (C[t][j] - C[t][it][:, None, :])).to(ED)
        # ---- pass end: the smallest packed (ss, m) becomes the root
        best = torch.argmin(_keys(ss, slots.to(torch.int32)), dim=-1)
        sol = chosen[fr, best]
    return sol.to(torch.int32)


def seqbeam_cuda(problem: SeqbeamProblem) -> torch.Tensor:
    """The CUDA kernel on the same problem as :func:`seqbeam_plain`."""
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
    int8 = e_dtype == "int8"
    if tables.centers_bf16.dtype != torch.bfloat16 or tables.gmod_bf16.dtype != torch.bfloat16 or (
            int8 and tables.centers_i8.dtype != torch.int8):
        raise TypeError("seqbeam tables must be bf16 centers and Gram blocks (int8 centers)")
    x = x.contiguous()
    idx0 = idx0.to(torch.int32).contiguous()
    centers = tables.centers_bf16.contiguous()
    gmod = tables.gmod_bf16.contiguous()
    ci8 = tables.centers_i8.contiguous() if int8 else None
    csc = tables.csc.float().contiguous() if int8 else None
    for t in (centers, gmod) + ((ci8, csc) if int8 else ()):
        if t.device != x.device:
            raise ValueError("seqbeam_cuda needs all tensors on one device")
    out = torch.empty(B, nc, dtype=torch.int32, device=x.device)
    words = (ctypes.c_uint32 * max(passes, 1))(*masks)
    SEQBEAM_KERNEL(
        x.data_ptr(), idx0.data_ptr(), centers.data_ptr(), gmod.data_ptr(),
        ci8.data_ptr() if int8 else None, csc.data_ptr() if int8 else None,
        out.data_ptr(), B, D, nc, M, R, passes, ctypes.addressof(words),
        E_DTYPES[e_dtype][0], torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


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
    change results and are ignored."""
    del block_b, interleave, zip_skew, cross_value, reorder, sel_impl
    if impl != "v2":
        raise NotImplementedError(
            f"seqbeam impl={impl!r} is not ported yet (ROADMAP B4: _seqbeam_kernel v1)")
    if requant != "step":
        raise NotImplementedError(
            f"seqbeam requant={requant!r} is not ported yet (ROADMAP B3)")
    if lazy_r1:
        raise NotImplementedError("seqbeam lazy_r1 is not ported yet (ROADMAP B3)")
    problem = seqbeam_problem(
        params, config, x, M, R, passes, pool_mask, e_dtype, init_indexes, init_precision)
    if x.device.type == "cuda":
        return seqbeam_cuda(problem)
    if x.device.type == "cpu":
        return seqbeam_plain(problem)
    raise ValueError(f"seqbeam runs on CUDA (kernel) or CPU (plain) tensors, not {x.device}")


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
) -> SeqbeamProblem:
    """The kernel's inputs for (B, dim) frames ``x``, on ``x``'s device:
    the initial indexes (the logits argmax unless ``init_indexes`` is
    given), the codebook tables and the per-pass pool schedule.  Raises
    ValueError for a config or beam shape the kernel does not take."""
    if not SEQBEAM_SUPPORTED(config):
        raise ValueError(f"seqbeam does not support {config}")
    if e_dtype not in E_DTYPES:
        raise ValueError(f"unknown e_dtype {e_dtype!r}")
    if M not in (8, 16, 32, 64) or R < 1 or M * R > 512:
        raise ValueError(f"seqbeam needs M in (8, 16, 32, 64) and M*R <= 512, got M={M}, R={R}")
    if not 1 <= passes <= MAX_PASSES:
        raise ValueError(f"passes must be in [1, {MAX_PASSES}], got {passes}")
    x = x.float().contiguous()
    if init_indexes is None:
        idx0 = init_indexes_from_logits(params, config, x, init_precision)
    else:
        idx0 = init_indexes.to(device=x.device, dtype=torch.int32)
        if idx0.shape != (x.shape[0], config.num_codebooks) or bool(
                ((idx0 < 0) | (idx0 >= config.codebook_size)).any()):
            raise ValueError("init_indexes must be (B, nc) codeword ids in [0, codebook_size)")
    tables = seqbeam_tables(scaled_centers(params, config.scale_speed), e_dtype == "int8")
    masks = pool_bits(pool_mask, config.num_codebooks, passes)
    return SeqbeamProblem(x, idx0.contiguous(), tables, M, R, passes, masks, e_dtype)
