"""Gram-table sequential-beam encode (gramv3): no per-candidate error buffer.

Counterpart of ``quantization_tpu/ops/gramv3.py::gramv3_encode_indexes``.
An M-wide beam sweeps the codebooks in order for ``passes`` passes, as in
seqbeam v2 (``ops/seqbeam.py``), but a candidate carries only its index row
and its squared error ``ss``.  With ``F`` the candidate's reconstruction
error, a step scores every codeword j of codebook t as

    S(j) = (ss - Q(i)) + Q(j),   Q(j) = 2 (SG(j) - XC_t(j)),
    SG(j) = sum_s Gt[s, t][ch_s, j]     (s = 0 .. nc-1, in that order)

where ``i`` is the candidate's current index at t, ``XC = x . W^T`` and
``Gt`` is the codeword Gram matrix with every diagonal block replaced by the
broadcast row ``csq_t[j] / 2``.  The CUDA kernel (``csrc/gramv3.cu``) gives
each frame one warp and sums the ``nc`` table rows per candidate;
:func:`gramv3_plain` is the same function in plain PyTorch, step for step,
and is what a CPU tensor runs.

Semantics carried over from the TPU kernels, each of which changes results:

* the tables: ``ctab = bf16(centers)``, ``csq = sum(ctab^2)`` in f32, the
  Gram matrix as f32 sums of bf16 products, stored in bf16, or in int8 with
  one global scale ``amax / 127`` (round half to even); for int8 the kernel
  works in scale-divided units, so XC and ``ss0`` are multiplied by
  ``inv = 1 / scale``;
* ``XC`` as f32 sums of bf16 products; ``ss0 = ||sum_s c_s(init_s) - x||^2``
  in f32 from the f32 centers;
* step 0 of each pass fans out from the root to its M best children;
* selection by packed mantissa, as in seqbeam v2: top-R per parent then the
  top M of the M*R pool with the parent id above the lane bits on a pool
  step, the best child in place on an R1 step;
* the pass ends on the smallest packed (ss, m), whose truncated ``ss`` is
  the next pass's root score (it is not recomputed).

The TPU's two kernels, ``_gramv3_fori_kernel`` (per-pass-uniform schedules)
and ``_gramv3_kernel`` (any schedule), are bit-identical by contract and
differ only in how Mosaic emits the codebook loop; one CUDA kernel taking a
pool bit word per pass replaces both.  ``loop="fori"`` still refuses a
mixed schedule, as the TPU wrapper does.  ``block_b`` and ``interleave`` are
scheduling knobs of the TPU wrapper and are accepted and ignored.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..core.types import QuantizerConfig, QuantizerParams, scaled_centers
from ..utils.device import dispatch
from .cuda_build import CudaKernel
from .seqbeam import LANE_BITS, LANE_MASK, _as_float, _keys, init_indexes_from_logits, pool_bits

G_DTYPES = {"bf16": 0, "int8": 1}
MAX_PASSES = 64
CS = 256

GRAMV3_KERNEL = CudaKernel(
    "gramv3", "qtt_gramv3_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_void_p],
)


def GRAMV3_SUPPORTED(config: QuantizerConfig) -> bool:
    """The kernel's constraints: 256 codewords a codebook and at most 8
    codebooks (the TPU's Gram table fits VMEM).  Any dim."""
    return config.codebook_size == CS and config.num_codebooks in (2, 4, 8)


@dataclasses.dataclass
class Gramv3Problem:
    """Everything the kernel and its plain version take: the (B, D) f32
    frames ``x`` (for scoring only), the (B, nc*cs) f32 ``xc``, the (B, nc)
    int32 initial indexes, the (B,) f32 root scores ``ss0`` (``xc`` and
    ``ss0`` in scale-divided units for int8), the table laid out per target
    codebook as (nc, nc*cs, cs) bf16 or int8 (``gt[t, s*cs + i, j] =
    Gt[s*cs + i, t*cs + j]``), the beam shape and one pool bit word per pass
    (``ops.seqbeam.pool_bits``)."""

    x: torch.Tensor
    xc: torch.Tensor
    idx0: torch.Tensor
    ss0: torch.Tensor
    gt: torch.Tensor
    M: int
    R: int
    passes: int
    masks: Tuple[int, ...]
    g_dtype: str


def _pass_modes(masks: Tuple[int, ...], nc: int):
    """Per-pass "pool" or "r1" when every non-first step of the pass is of
    that kind, or None for a mixed schedule (``altparity``); step 0 is the
    fan-out either way."""
    tail = ((1 << nc) - 1) & ~1
    modes = []
    for word in masks:
        if word & tail == tail:
            modes.append("pool")
        elif word & tail == 0:
            modes.append("r1")
        else:
            return None
    return tuple(modes)


@torch.no_grad()
def gramv3_problem(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    M: int = 8,
    R: int = 4,
    passes: int = 3,
    pool_mask=None,
    g_dtype: str = "bf16",
    init_indexes: Optional[torch.Tensor] = None,
) -> Gramv3Problem:
    """The kernel's inputs for (B, dim) frames ``x``, on ``x``'s device,
    computed as the TPU wrapper computes them (``gramv3.py:675-710``).
    Raises ValueError for a config or beam shape the kernel does not take."""
    if not GRAMV3_SUPPORTED(config):
        raise ValueError(f"gramv3 does not support {config}")
    if g_dtype not in G_DTYPES:
        raise ValueError(f"unknown g_dtype {g_dtype!r}")
    if M not in (8, 16, 32, 64) or R < 1 or M * R > 256:
        raise ValueError(f"gramv3 needs M in (8, 16, 32, 64) and M*R <= 256, got M={M}, R={R}")
    if not 0 <= passes <= MAX_PASSES:
        raise ValueError(f"passes must be in [0, {MAX_PASSES}], got {passes}")
    nc, cs, D = config.num_codebooks, config.codebook_size, config.dim
    K = nc * cs
    x = x.float().contiguous()
    if x.ndim != 2 or x.shape[1] != D:
        raise ValueError(f"expected (B, {D}) frames, got {tuple(x.shape)}")
    if init_indexes is None:
        idx0 = init_indexes_from_logits(params, config, x)
    else:
        idx0 = init_indexes.to(device=x.device, dtype=torch.int32)
        if idx0.shape != (x.shape[0], nc) or bool(((idx0 < 0) | (idx0 >= cs)).any()):
            raise ValueError("init_indexes must be (B, nc) codeword ids in [0, codebook_size)")
    masks = pool_bits(pool_mask, nc, passes)

    centers = scaled_centers(params, config.scale_speed).detach().float()  # (nc, cs, D)
    # bf16 operands, f32 products and sums (jnp.dot(bf16, bf16,
    # preferred_element_type=f32) keeps f32; a bf16 torch.matmul would not)
    ctab = centers.reshape(K, D).to(torch.bfloat16).float()
    csq = (ctab * ctab).sum(dim=-1)  # (K,)
    blk = torch.arange(nc, device=x.device).repeat_interleave(cs)
    gtil = torch.where(blk[:, None] == blk[None, :], (csq / 2.0)[None, :], ctab @ ctab.t())
    if g_dtype == "int8":
        amax = gtil.abs().max()
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        gtil = torch.round(gtil / scale).to(torch.int8)
        inv = 1.0 / scale
    else:
        gtil = gtil.to(torch.bfloat16)
        inv = None
    xc = x.to(torch.bfloat16).float() @ ctab.t()  # (B, K)
    recon0 = centers[torch.arange(nc, device=x.device)[None, :], idx0.long()].sum(dim=1)
    ss0 = ((recon0 - x) ** 2).sum(dim=-1)
    if inv is not None:
        xc, ss0 = xc * inv, ss0 * inv
    gt = gtil.reshape(K, nc, cs).permute(1, 0, 2).contiguous()  # (nc, K, cs)
    return Gramv3Problem(x, xc.contiguous(), idx0.contiguous(), ss0.contiguous(), gt,
                         M, R, passes, masks, g_dtype)


def _sg(gt_t: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """SG rows (..., cs) for index rows ``ch`` (..., nc) against target
    block ``gt_t`` (nc*cs, cs): the nc table rows summed in codebook order,
    in f32 (bf16 tables) or exactly in int32 (int8 tables)."""
    nc = ch.shape[-1]
    acc = None
    for s in range(nc):
        row = gt_t[s * CS + ch[..., s]]
        row = row.int() if gt_t.dtype == torch.int8 else row.float()
        acc = row if acc is None else acc + row
    return acc.float()


def gramv3_plain(problem: Gramv3Problem) -> torch.Tensor:
    """Plain PyTorch version of the gramv3 kernel: the problem's inputs ->
    (B, nc) int32 indexes."""
    xc, gt, M, R = problem.xc, problem.gt, problem.M, problem.R
    nc = gt.shape[0]
    B = xc.shape[0]
    dev = xc.device
    fr = torch.arange(B, device=dev)
    lanes = torch.arange(CS, dtype=torch.int32, device=dev)
    slots = torch.arange(M, device=dev)
    mbits = (M - 1) << LANE_BITS
    sol = problem.idx0.long().clone()  # (B, nc)
    ss_root = problem.ss0.clone()  # (B,)
    for p in range(problem.passes):
        # ---- step 0: fan out from the root to its M best children
        Q0 = 2.0 * (_sg(gt[0], sol) - xc[:, 0:CS])  # (B, cs)
        S0 = (ss_root - Q0[fr, sol[:, 0]])[:, None] + Q0
        top = torch.topk(_keys(S0, lanes), M, dim=-1, largest=False, sorted=True).values
        ss = _as_float(top & ~LANE_MASK)  # (B, M)
        ch = sol[:, None, :].repeat(1, M, 1)  # (B, M, nc)
        ch[:, :, 0] = (top & LANE_MASK).long()
        # ---- steps 1..nc-1
        for t in range(1, nc):
            Q = 2.0 * (_sg(gt[t], ch) - xc[:, None, t * CS:(t + 1) * CS])  # (B, M, cs)
            Qi = torch.gather(Q, 2, ch[:, :, t:t + 1])[..., 0]
            keys = _keys((ss - Qi)[..., None] + Q, lanes)
            if not (problem.masks[p] >> t) & 1:
                # R1: each parent keeps its best child in place
                w = keys.min(dim=-1).values
                ss = _as_float(w & ~LANE_MASK)
                ch[:, :, t] = (w & LANE_MASK).long()
                continue
            rk = torch.topk(keys, R, dim=-1, largest=False, sorted=True).values
            pk = (rk & ~mbits) | (slots.to(torch.int32) << LANE_BITS)[None, :, None]
            w = torch.topk(pk.reshape(B, M * R), M, dim=-1, largest=False, sorted=True).values
            parent = ((w >> LANE_BITS) & (M - 1)).long()
            ch = torch.gather(ch, 1, parent[..., None].expand(B, M, nc))
            ch[:, :, t] = (w & LANE_MASK).long()
            ss = _as_float(w & ~(mbits | LANE_MASK))
        # ---- pass end: the smallest packed (ss, m) becomes the root
        wk = _keys(ss, slots.to(torch.int32)).min(dim=-1).values
        sol = ch[fr, (wk & LANE_MASK).long()]
        ss_root = _as_float(wk & ~LANE_MASK)
    return sol.to(torch.int32)


def gramv3_cuda(problem: Gramv3Problem) -> torch.Tensor:
    """The CUDA kernel on the same problem as :func:`gramv3_plain`."""
    xc, idx0, ss0, gt = problem.xc, problem.idx0, problem.ss0, problem.gt
    nc = gt.shape[0]
    K = nc * CS
    B = xc.shape[0]
    if not xc.is_cuda:
        raise ValueError("gramv3_cuda needs CUDA tensors")
    want_gt = torch.int8 if problem.g_dtype == "int8" else torch.bfloat16
    if (xc.dtype != torch.float32 or xc.shape != (B, K) or idx0.shape != (B, nc)
            or ss0.shape != (B,) or ss0.dtype != torch.float32
            or gt.shape != (nc, K, CS) or gt.dtype != want_gt):
        raise ValueError(
            f"gramv3 inputs must be xc (B, {K}) f32, idx0 (B, {nc}), ss0 (B,) f32 and the "
            f"table ({nc}, {K}, {CS}) {want_gt}")
    if len(problem.masks) != problem.passes:
        raise ValueError(f"expected {problem.passes} pool masks, got {len(problem.masks)}")
    xc, ss0, gt = xc.contiguous(), ss0.contiguous(), gt.contiguous()
    idx0 = idx0.to(torch.int32).contiguous()
    if any(t.device != xc.device for t in (idx0, ss0, gt)):
        raise ValueError("gramv3_cuda needs all tensors on one device")
    out = torch.empty(B, nc, dtype=torch.int32, device=xc.device)
    words = (ctypes.c_uint32 * max(problem.passes, 1))(*problem.masks)
    GRAMV3_KERNEL(
        xc.data_ptr(), idx0.data_ptr(), ss0.data_ptr(), gt.data_ptr(), out.data_ptr(),
        B, nc, problem.M, problem.R, problem.passes, ctypes.addressof(words),
        G_DTYPES[problem.g_dtype], torch.cuda.current_stream(xc.device).cuda_stream,
    )
    return out


def gramv3_encode_indexes(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    M: int = 8,
    R: int = 4,
    passes: int = 3,
    pool_mask=None,
    g_dtype: str = "bf16",
    block_b: int = 128,
    interleave: int = 1,
    loop: str = "auto",
    init_indexes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Encode (B, dim) frames to (B, nc) int32 indexes with the Gram-table
    beam: the kernel on a CUDA tensor, its plain version on a CPU tensor.

    ``g_dtype``: "bf16" or "int8" (one global table scale).  ``pool_mask``
    takes the forms of seqbeam's (None = all-pool, per-step bools, per-pass
    tuples or a named schedule).  ``loop``: "auto", "unroll" or "fori";
    "fori" raises ValueError on a schedule that is not uniform within each
    pass, as the TPU wrapper does.  ``block_b`` and ``interleave`` do not
    change results and are ignored."""
    del block_b, interleave
    if loop not in ("auto", "fori", "unroll"):
        raise ValueError(f"unknown loop {loop!r}")
    problem = gramv3_problem(params, config, x, M, R, passes, pool_mask, g_dtype, init_indexes)
    if loop == "fori" and _pass_modes(problem.masks, config.num_codebooks) is None:
        raise ValueError(
            f"loop='fori' needs a per-pass-uniform pool schedule; got {pool_mask!r}")
    return dispatch("gramv3", x.device, gramv3_cuda, gramv3_plain, problem)
