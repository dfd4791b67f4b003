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
each frame one warp; at step t it stages the rows s >= t that every
candidate shares once, and a candidate loads its own rows s < t.  bf16 at
16 codebooks stages nothing: each candidate loads all its nc rows and the
L1 cache serves the repeats (:func:`rows_path`, counted in
:data:`ALL_ROWS_LAUNCHES`).
:func:`gramv3_plain` is the same function in plain PyTorch, step for step,
and is what a CPU tensor runs; :func:`gramv3_stages` runs the kernel's
stage-timed build.

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

import collections
import ctypes
import dataclasses
import functools
import warnings
from typing import Optional, Tuple

import torch

from ..core.types import QuantizerConfig, QuantizerParams
from ..utils.device import dispatch
from ..utils.spans import span
from .beam_common import (LANE_BITS, LANE_MASK, MAX_PASSES, SearchKernel, as_float,
                          initial_indexes, on_one_device, packed_keys, pool_bits)
from .cuda_build import CFunction, CudaKernel
from .tables_cache import TablesCache

G_DTYPES = {"bf16": 0, "int8": 1}
CS = 256

_LAUNCH_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
GRAMV3_KERNEL = CudaKernel("gramv3", "qtt_gramv3_launch", _LAUNCH_ARGS + [ctypes.c_void_p])
# the stage-timed build: the launch's arguments, then the stage buffer
GRAMV3_TIMED_KERNEL = CudaKernel("gramv3", "qtt_gramv3_timed_launch",
                                 _LAUNCH_ARGS + [ctypes.c_void_p] * 2)
OCCUPANCY = CFunction("gramv3", "qtt_gramv3_occupancy", [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the timed build's stages, in the order of its buffer's columns
STAGES = ("root", "load", "score", "topr", "pool", "reorder", "pass_end")
FRAMES_PER_BLOCK = 4  # one warp a frame
# the beam widths the kernel is built for, by codebooks: 16 codebooks only at
# auto's beam (M=8; the TPU kernels stop at 8, whose Gram table fits VMEM)
BUILT_M = {2: (8, 16, 32, 64), 4: (8, 16, 32, 64), 8: (8, 16, 32, 64), 16: (8,)}
# the kernel's launches by codebooks, as ``GRAMV3_KERNEL.launches`` counts
# them all
NC_LAUNCHES: collections.Counter = collections.Counter()
# the launches whose candidates each load all nc table rows (``rows_path``
# is "all"), the stage-timed build's included
ALL_ROWS_LAUNCHES = 0
ALL_ROWS = CFunction("gramv3", "qtt_gramv3_all_rows", [ctypes.c_int] * 2)


@functools.lru_cache(maxsize=None)
def rows_path(g_dtype: str, nc: int) -> str:
    """How the kernel at ``nc`` codebooks with a ``g_dtype`` table gets a
    step's table rows, as the built kernel reports it (``kAllRows`` in
    csrc/gramv3.cu; it builds the library): "all" (every candidate loads
    all nc of its rows, the L1 cache serving the repeats, and the kernel
    takes no shared memory; bf16 at 16 codebooks) or "staged" (the rows
    that every candidate shares loaded once a step, as f32 rows in shared
    memory for bf16 or one register sum for int8, and a candidate's own
    rows loaded as it is scored)."""
    got = ALL_ROWS(nc, G_DTYPES[g_dtype])
    if got < 0:
        raise ValueError(f"no gramv3 kernel at {nc} codebooks with a {g_dtype} table")
    return "all" if got else "staged"


def GRAMV3_SUPPORTED(config: QuantizerConfig) -> bool:
    """The kernel's constraints: 256 codewords a codebook and 2, 4, 8 or
    16 codebooks.  Any dim."""
    return config.codebook_size == CS and config.num_codebooks in BUILT_M


@dataclasses.dataclass
class Gramv3Problem:
    """Everything the kernel and its plain version take: the (B, D) f32
    frames ``x`` (for scoring only), the (B, nc*cs) f32 ``xc``, the (B, nc)
    int32 initial indexes, the (B,) f32 root scores ``ss0`` (``xc`` and
    ``ss0`` in scale-divided units for int8), the table laid out per target
    codebook as (nc, nc*cs, cs) bf16 or int8 (``gt[t, s*cs + i, j] =
    Gt[s*cs + i, t*cs + j]``), the beam shape and one pool bit word per pass
    (``ops.beam_common.pool_bits``)."""

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

    @property
    def kernel(self) -> SearchKernel:
        return GRAMV3


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


@dataclasses.dataclass
class Gramv3Tables:
    """What a problem takes from the parameters alone, for one ``g_dtype``:
    the (nc, cs, D) f32 scaled centers (the root scores read them), their
    (K, D) bf16 copy ``ctab`` (the cross terms' operand), the laid-out
    table ``gt`` and, for int8, ``inv = 1 / scale`` (else None), checked
    here (TypeError), once a parameter version, and not at a launch."""

    centers: torch.Tensor
    ctab: torch.Tensor
    gt: torch.Tensor
    inv: Optional[torch.Tensor]

    def __post_init__(self):
        if (self.centers.dtype, self.ctab.dtype, self.gt.dtype) != (
                torch.float32, torch.bfloat16, torch.bfloat16 if self.inv is None else torch.int8):
            raise TypeError("gramv3 tables must hold f32 centers, bf16 codewords and a bf16 "
                            "table, or an int8 one with its inverse scale")
        if not all(t.is_contiguous() for t in (self.centers, self.ctab, self.gt)):
            raise TypeError("gramv3 tables must be contiguous")


def gramv3_tables(centers: torch.Tensor, g_dtype: str = "bf16") -> Gramv3Tables:
    """The tables of (nc, cs, D) f32 scaled centers."""
    nc, cs, D = centers.shape
    centers = centers.detach().float().contiguous()
    ctab = centers.reshape(nc * cs, D).to(torch.bfloat16)
    gtil, inv = gram_table(ctab, nc, g_dtype)
    return Gramv3Tables(centers, ctab, table_layout(gtil, nc), inv)


# the variant: (g_dtype,); an entry at d1280 is about 24 MB at 8 codebooks,
# 47 MB at 16 (the bf16 table 33.5 MB); a build's span records the table's
# bytes
TABLES_CACHE = TablesCache(8, "gramv3", gramv3_tables, nbytes=lambda t: t.gt.nbytes)


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
    computed as the TPU wrapper computes them (``gramv3.py:675-710``): the
    tables from :data:`TABLES_CACHE`, then what the frames give (the
    ``gramv3.init`` span: the initial indexes, the cross terms and the root
    scores).  Raises ValueError for a config or beam shape the kernel does
    not take."""
    if not GRAMV3_SUPPORTED(config):
        raise ValueError(f"gramv3 does not support {config}")
    if g_dtype not in G_DTYPES:
        raise ValueError(f"unknown g_dtype {g_dtype!r}")
    if M not in (8, 16, 32, 64) or R < 1 or M * R > 256:
        raise ValueError(f"gramv3 needs M in (8, 16, 32, 64) and M*R <= 256, got M={M}, R={R}")
    if not 0 <= passes <= MAX_PASSES:
        raise ValueError(f"passes must be in [0, {MAX_PASSES}], got {passes}")
    nc, D = config.num_codebooks, config.dim
    x = x.float().contiguous()
    if x.ndim != 2 or x.shape[1] != D:
        raise ValueError(f"expected (B, {D}) frames, got {tuple(x.shape)}")
    masks = pool_bits(pool_mask, nc, passes)
    tables = TABLES_CACHE.get(params, config.scale_speed, g_dtype)
    with span("gramv3.init"):
        idx0 = initial_indexes(params, config, x, init_indexes)
        xc = cross_terms(x, tables.ctab)
        ss0 = root_scores(tables.centers, idx0, x)
        if tables.inv is not None:
            xc, ss0 = xc * tables.inv, ss0 * tables.inv
    return Gramv3Problem(x, xc.contiguous(), idx0, ss0.contiguous(), tables.gt, M, R, passes,
                         masks, g_dtype)


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.t()`` of bf16 operands as f32 sums of their exact products,
    as ``jnp.dot(bf16, bf16, preferred_element_type=f32)`` computes it.

    On the card it runs on the tensor cores with f32 output (``torch.mm``'s
    ``out_dtype``, or a TF32 product where that torch lacks it: TF32 holds
    every bf16 value exactly); the products are exact either way and only
    the order of the f32 sums moves.  On the CPU it is the f32 product."""
    if not a.is_cuda:
        return a.float() @ b.float().t()
    if "dtype" in torch.ops.aten.mm.overloads():
        return torch.mm(a, b.t(), out_dtype=torch.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.float() @ b.float().t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def gram_table(ctab: torch.Tensor, nc: int, g_dtype: str):
    """The (K, K) table ``Gt`` of the (K, D) bf16 codewords ``ctab``: their
    Gram matrix with every diagonal block replaced by the broadcast row
    ``csq_t[j] / 2``, in bf16, or in int8 with one global scale; returns the
    table and, for int8, ``1 / scale`` (else None)."""
    cs = ctab.shape[0] // nc
    ctab_f = ctab.float()
    csq = (ctab_f * ctab_f).sum(dim=-1)  # (K,)
    blk = torch.arange(nc, device=ctab.device).repeat_interleave(cs)
    gtil = torch.where(blk[:, None] == blk[None, :], (csq / 2.0)[None, :],
                       bf16_product(ctab, ctab))
    if g_dtype == "int8":
        amax = gtil.abs().max()
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        return torch.round(gtil / scale).to(torch.int8), 1.0 / scale
    return gtil.to(torch.bfloat16), None


def cross_terms(x: torch.Tensor, ctab: torch.Tensor) -> torch.Tensor:
    """``XC = bf16(x) . ctab^T``, (B, K) f32."""
    return bf16_product(x.to(torch.bfloat16), ctab)


def root_scores(centers: torch.Tensor, idx0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``ss0 = ||sum_s c_s(idx0_s) - x||^2`` in f32 from the (nc, cs, D) f32
    centers.  On the card the codeword sums are one sparse product (a row
    of nc ones a frame) and need no (B, nc, D) temporary."""
    nc, cs, D = centers.shape
    if x.is_cuda:
        B = x.shape[0]
        cols = idx0.long() + cs * torch.arange(nc, device=x.device)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            warnings.filterwarnings("ignore", "Sparse invariant checks are implicitly disabled")
            pick = torch.sparse_csr_tensor(
                torch.arange(0, B * nc + 1, nc, device=x.device), cols.reshape(-1),
                torch.ones(B * nc, device=x.device), size=(B, nc * cs), check_invariants=False)
            recon0 = pick @ centers.reshape(nc * cs, D)
    else:
        recon0 = centers[torch.arange(nc, device=x.device)[None, :], idx0.long()].sum(dim=1)
    return ((recon0 - x) ** 2).sum(dim=-1)


def table_layout(gtil: torch.Tensor, nc: int) -> torch.Tensor:
    """The (K, K) table laid out per target codebook, (nc, K, cs):
    ``gt[t, s*cs + i, j] = Gt[s*cs + i, t*cs + j]``."""
    K = gtil.shape[0]
    return gtil.reshape(K, nc, K // nc).permute(1, 0, 2).contiguous()


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
        top = torch.topk(packed_keys(S0, lanes), M, dim=-1, largest=False, sorted=True).values
        ss = as_float(top & ~LANE_MASK)  # (B, M)
        ch = sol[:, None, :].repeat(1, M, 1)  # (B, M, nc)
        ch[:, :, 0] = (top & LANE_MASK).long()
        # ---- steps 1..nc-1
        for t in range(1, nc):
            Q = 2.0 * (_sg(gt[t], ch) - xc[:, None, t * CS:(t + 1) * CS])  # (B, M, cs)
            Qi = torch.gather(Q, 2, ch[:, :, t:t + 1])[..., 0]
            keys = packed_keys((ss - Qi)[..., None] + Q, lanes)
            if not (problem.masks[p] >> t) & 1:
                # R1: each parent keeps its best child in place
                w = keys.min(dim=-1).values
                ss = as_float(w & ~LANE_MASK)
                ch[:, :, t] = (w & LANE_MASK).long()
                continue
            rk = torch.topk(keys, R, dim=-1, largest=False, sorted=True).values
            pk = (rk & ~mbits) | (slots.to(torch.int32) << LANE_BITS)[None, :, None]
            w = torch.topk(pk.reshape(B, M * R), M, dim=-1, largest=False, sorted=True).values
            parent = ((w >> LANE_BITS) & (M - 1)).long()
            ch = torch.gather(ch, 1, parent[..., None].expand(B, M, nc))
            ch[:, :, t] = (w & LANE_MASK).long()
            ss = as_float(w & ~(mbits | LANE_MASK))
        # ---- pass end: the smallest packed (ss, m) becomes the root
        wk = packed_keys(ss, slots.to(torch.int32)).min(dim=-1).values
        sol = ch[fr, (wk & LANE_MASK).long()]
        ss_root = as_float(wk & ~LANE_MASK)
    return sol.to(torch.int32)


def _launch(problem: Gramv3Problem, kernel: CudaKernel, *extra) -> torch.Tensor:
    """Check the call's tensors of ``problem`` and launch ``kernel`` on them
    and its table (checked at its build) with the ``extra`` arguments before
    the stream (the ``gramv3.launch`` span, with the table's dtype, the
    codebooks and, once the tensors pass, how the kernel gets the rows,
    ``rows`` from :func:`rows_path`); counts it in
    :data:`NC_LAUNCHES` and, where it loads all rows,
    :data:`ALL_ROWS_LAUNCHES`; returns the (B, nc) indexes."""
    global ALL_ROWS_LAUNCHES
    nc = problem.gt.shape[0]
    with span("gramv3.launch", g_dtype=problem.g_dtype, nc=nc) as sp:
        xc, idx0, ss0, gt = problem.xc, problem.idx0, problem.ss0, problem.gt
        K = nc * CS
        B = xc.shape[0]
        if not xc.is_cuda:
            raise ValueError(f"{kernel.symbol} needs CUDA tensors")
        if (xc.dtype != torch.float32 or xc.shape != (B, K) or idx0.shape != (B, nc)
                or idx0.dtype != torch.int32 or ss0.shape != (B,) or ss0.dtype != torch.float32
                or not all(t.is_contiguous() for t in (xc, idx0, ss0))):
            raise ValueError(f"gramv3 inputs must be contiguous xc (B, {K}) f32, idx0 (B, {nc}) "
                             "int32 and ss0 (B,) f32")
        if len(problem.masks) != problem.passes:
            raise ValueError(f"expected {problem.passes} pool masks, got {len(problem.masks)}")
        if problem.M not in BUILT_M[nc]:
            raise ValueError(f"the gramv3 kernel at {nc} codebooks is built for M in "
                             f"{BUILT_M[nc]}, got M={problem.M}")
        on_one_device("gramv3_cuda", xc, idx0, ss0, gt)
        rows = rows_path(problem.g_dtype, nc)
        sp.set(rows=rows)
        out = torch.empty(B, nc, dtype=torch.int32, device=xc.device)
        words = (ctypes.c_uint32 * max(problem.passes, 1))(*problem.masks)
        kernel(
            xc.data_ptr(), idx0.data_ptr(), ss0.data_ptr(), gt.data_ptr(), out.data_ptr(),
            B, nc, problem.M, problem.R, problem.passes, ctypes.addressof(words),
            G_DTYPES[problem.g_dtype], *extra, torch.cuda.current_stream(xc.device).cuda_stream,
        )
        NC_LAUNCHES[nc] += 1
        if rows == "all":
            ALL_ROWS_LAUNCHES += 1
        return out


def gramv3_cuda(problem: Gramv3Problem) -> torch.Tensor:
    """The CUDA kernel on the same problem as :func:`gramv3_plain`."""
    return _launch(problem, GRAMV3_KERNEL)


def gramv3_stages(problem: Gramv3Problem) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage-timed build of the kernel on the same problem as
    :func:`gramv3_cuda`: the same (B, nc) indexes, and a (blocks,
    len(STAGES) + 2) int64 tensor holding, per block of
    :data:`FRAMES_PER_BLOCK` frames, the ``clock64()`` cycles of each of
    :data:`STAGES` summed over the block's warps (one a frame), then the
    longest warp's own cycles and nanoseconds.  Built for the serving
    path's beam only (M=8, any R and schedule; at 16 codebooks bf16 only);
    CUDA tensors only."""
    if problem.M != 8:
        raise ValueError("the stage-timed gramv3 takes M=8")
    if not problem.xc.is_cuda:
        raise ValueError("gramv3_stages needs CUDA tensors")
    blocks = -(-problem.xc.shape[0] // FRAMES_PER_BLOCK)
    stages = torch.zeros(blocks, len(STAGES) + 2, dtype=torch.int64, device=problem.xc.device)
    return _launch(problem, GRAMV3_TIMED_KERNEL, stages.data_ptr()), stages


def gramv3_occupancy(problem: Gramv3Problem, timed: bool = False) -> dict:
    """Registers a thread, threads a block, resident blocks an SM and
    shared memory a block of the kernel that ``problem`` launches (of its
    stage-timed build where ``timed``), as the CUDA runtime reports them."""
    out = (ctypes.c_int * 4)()
    err = OCCUPANCY(problem.gt.shape[0], problem.M, G_DTYPES[problem.g_dtype], int(timed),
                    ctypes.addressof(out))
    if err:
        raise RuntimeError(f"qtt_gramv3_occupancy failed: CUDA error {err}")
    return {"registers": out[0], "blocks_per_sm": out[1], "threads_per_block": out[2],
            "smem_bytes": out[3]}


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
    change results and are ignored, but ``interleave`` must divide
    ``block_b``, as the TPU kernels assert."""
    if block_b % interleave:
        raise ValueError(f"interleave={interleave} does not divide block_b={block_b}")
    if loop not in ("auto", "fori", "unroll"):
        raise ValueError(f"unknown loop {loop!r}")
    problem = gramv3_problem(params, config, x, M, R, passes, pool_mask, g_dtype, init_indexes)
    if loop == "fori" and _pass_modes(problem.masks, config.num_codebooks) is None:
        raise ValueError(
            f"loop='fori' needs a per-pass-uniform pool schedule; got {pool_mask!r}")
    return dispatch("gramv3", x.device, gramv3_cuda, gramv3_plain, problem)


GRAMV3 = SearchKernel("gramv3", GRAMV3_SUPPORTED, gramv3_problem, gramv3_cuda, gramv3_plain,
                      GRAMV3_KERNEL, TABLES_CACHE, lambda *a, **kw: gramv3_encode_indexes(*a, **kw))
