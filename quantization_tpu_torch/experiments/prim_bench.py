"""Micro-benchmarks of the seqbeam kernel's primitive units on the card.

Counterpart of ``experiments/prim_bench.py``.  Each probe repeats ONE
primitive K times on data held on chip, in one launch of a hand-written
kernel (``csrc/prim_bench.cu``), so that the cost of one iteration is the
slope of the device time between two values of K (the launch cost cancels):

- ``minround``: K rounds of packed-min selection over (rows, 128) f32, the
  selection unit.  The key is ``max(x, 0)``'s bits with the 8 low bits
  replaced by the lane; each round, every row's smallest key (unsigned
  order) becomes 1e30, which counts as a key in later rounds;
- ``gather``: K gathers along the 8 rows of an (8, N) f32 table,
  ``acc[r, n] += x[(idx[r, n] + i) mod 8, n]``, the M=8 reorder unit;
- ``matmul``: K products ``bf16(a + i) . b^T`` with f32 sums, added up in
  f32, the rescore unit;
- ``assembly``: K passes of the fused elementwise score assembly
  ``((acc - 2 col) + row) + 2 (acc - row)`` over (rows, cs).

Each has a plain PyTorch version (``*_plain``), step for step the JAX
kernel's arithmetic, and the kernel (``*_cuda``); the dispatcher of each
probe runs the kernel on a CUDA tensor and the plain version on a CPU
tensor.

The matmul's stage-timed build (:func:`matmul_stages`, its own entry point
and count) says where an iteration's time goes.  Beside the ops bounds,
minround and gather have floors, each the slope of a floor kernel timed on
the card (:func:`minround_floor_us`, a chain of warp-wide reductions;
:func:`gather_floor_us`, the gather's shared loads from fixed rows, with no
index math); :func:`minround_floor_line` also gives what a call of minround
costs beside its rounds (its sort runs once a call).

Run on the card:  python -m quantization_tpu_torch.experiments.prim_bench [--stages | --floors]
(``--stages``: the matmul's ``[matmul stages]`` line in place of the probes'
times; ``--floors``: the ``[floor minround]`` and ``[floor gather]`` lines)
"""

from __future__ import annotations

import ctypes
import struct
import sys
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from ..ops.cuda_build import CFunction, CudaKernel
from ..utils.device import device_ms, dispatch, nvidia_smi_line

INF = 1e30
MASK = 255
INF_BITS = struct.unpack("<I", struct.pack("<f", INF))[0]
LANES = 128
GATHER_ROWS = 8

MINROUND_KERNEL = CudaKernel(
    "prim_bench", "qtt_minround_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
# x, out, rows, K, stream: minround's floor, K dependent warp-wide reductions a row
REDUX_CHAIN_KERNEL = CudaKernel(
    "prim_bench", "qtt_redux_chain_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
GATHER_KERNEL = CudaKernel(
    "prim_bench", "qtt_gather_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
# x, idx, out, N, K, stream: the gather's floor, its loads from fixed rows
GATHER_FLOOR_KERNEL = CudaKernel(
    "prim_bench", "qtt_gather_floor_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_void_p])
# a, b, out, part, count, M, N, D, K, stream
MATMUL_KERNEL = CudaKernel(
    "prim_bench", "qtt_matmul_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p])
# the matmul's stage-timed build: the launch's arguments, then the stage buffer
MATMUL_TIMED_KERNEL = CudaKernel(
    "prim_bench", "qtt_matmul_timed_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 2)
MATMUL_OCCUPANCY = CFunction("prim_bench", "qtt_matmul_occupancy",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the timed build's stages, in the order of its buffer's columns
MATMUL_STAGES = ("load", "convert", "mma", "acc", "epilogue")
ASSEMBLY_KERNEL = CudaKernel(
    "prim_bench", "qtt_assembly_launch", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p])
KERNELS = {"minround": MINROUND_KERNEL, "gather": GATHER_KERNEL, "matmul": MATMUL_KERNEL,
           "assembly": ASSEMBLY_KERNEL}

# csrc/prim_bench.cu: a tile of the product (rows, columns), whose sum over
# the dimensions MATMUL_SPLIT blocks share
MATMUL_TILE = (64, 128)
MATMUL_SPLIT = 4
MATMUL_MAX_D = 512  # 8 warpgroups x 4 k-steps of 16: what the tile's registers hold

# the shared-memory pipe, beside the gather's measured floor: an SM serves
# 32 four-byte loads a clock, at the clock of the f32 ops bound (33.5e12
# adds a second = 132 SMs x 128 lanes x 1.98 GHz)
SHARED_LOADS_PER_CLOCK = 32
BOUND_CLOCK_HZ = 1.98e9


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} needs its tensors on one CUDA device")


# ---- minround: the selection unit


def _keys(x: torch.Tensor) -> torch.Tensor:
    """The packed keys of (rows, 128) float32, as unsigned 32-bit integers
    held in int64: ``max(x, 0)``'s bits with the low byte replaced by the
    lane."""
    lane = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    bits = torch.clamp_min(x, 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits & ~MASK) | lane


def _as_int32(key: torch.Tensor) -> torch.Tensor:
    return torch.where(key >= 2**31, key - 2**32, key).to(torch.int32)


def minround_plain(x: torch.Tensor, K: int) -> torch.Tensor:
    """K rounds of packed-min selection over (rows, 128) float32.  Keys are
    compared as unsigned 32-bit integers, which is the order of the packed
    floats for every non-negative input.  A taken key becomes 1e30 in place
    and takes part in later rounds; a round whose least key is 1e30 takes
    nothing (its low byte, 0xCA, names no lane)."""
    lane = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    key = _keys(x)
    for _ in range(K):
        pos = key.min(dim=1, keepdim=True).values & MASK
        key = torch.where(lane == pos, INF_BITS, key)
    return _as_int32(key).view(torch.float32)


def _minround_args(name: str, x: torch.Tensor) -> torch.Tensor:
    _check_cuda(name, x)
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != LANES:
        raise ValueError(f"expected (rows, {LANES}) float32, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def minround_cuda(x: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel (each lane's 4 keys sorted once, then one warp-wide
    reduction, one compare and one select a round) on the same inputs as
    :func:`minround_plain`."""
    x = _minround_args("minround_cuda", x)
    out = torch.empty_like(x)
    MINROUND_KERNEL(x.data_ptr(), out.data_ptr(), x.shape[0], K, _stream(x))
    return out


def redux_chain_cuda(x: torch.Tensor, K: int) -> torch.Tensor:
    """Minround's floor kernel: on minround's grid, each row's warp takes its
    least key, then runs K dependent warp-wide reductions and nothing else.
    Returns each row's least key (bits as int32), :func:`row_least_key`'s
    value.  CUDA tensors only."""
    x = _minround_args("redux_chain_cuda", x)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    REDUX_CHAIN_KERNEL(x.data_ptr(), out.data_ptr(), x.shape[0], K, _stream(x))
    return out


def row_least_key(x: torch.Tensor) -> torch.Tensor:
    """Each row's least packed key (bits as int32)."""
    return _as_int32(_keys(x).min(dim=1).values)


def minround_floor_us(x: torch.Tensor, Ks: Tuple[int, int] = (32, 96)) -> float:
    """Microseconds a round that no design of one warp-wide reduction a
    round goes below: the slope of :func:`redux_chain_cuda` on ``x``
    between the two K (a reduction's latency, as the card runs it)."""
    return slope_us(lambda K: redux_chain_cuda(x, K), *Ks)


def minround(x: torch.Tensor, K: int) -> torch.Tensor:
    """K packed-min rounds: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    return dispatch("minround", x.device, minround_cuda, minround_plain, x, K)


# ---- gather: the M=8 reorder unit


def gather_plain(x: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """``acc[r, n] = sum_{i<K} x[(idx[r, n] + i) mod 8, n]`` over (8, N)
    float32, summed in order from 0.  The mod is a floor mod, as ``jnp``'s
    ``%``: negative indexes land in [0, 8) too."""
    acc = torch.zeros_like(x)
    for i in range(K):
        acc = acc + torch.gather(x, 0, torch.remainder(idx + i, GATHER_ROWS).long())
    return acc


def _gather_args(name: str, x: torch.Tensor, idx: torch.Tensor):
    _check_cuda(name, x, idx)
    if (x.dtype != torch.float32 or idx.dtype != torch.int32 or x.ndim != 2
            or x.shape[0] != GATHER_ROWS or idx.shape != x.shape):
        raise ValueError(f"expected (8, N) float32 and int32, got {x.dtype} {tuple(x.shape)}, "
                         f"{idx.dtype} {tuple(idx.shape)}")
    return x.contiguous(), idx.contiguous()


def gather_cuda(x: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel (one thread a column, its 8 rows in shared memory 1 KB
    apart; a gather is an add, a mask, a shared load and an add) on the same
    inputs as :func:`gather_plain`."""
    x, idx = _gather_args("gather_cuda", x, idx)
    out = torch.empty_like(x)
    GATHER_KERNEL(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[1], K, _stream(x))
    return out


def gather_floor_cuda(x: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """The gather's floor kernel: the kernel's table, grid and loads with
    each row fixed at ``idx mod 8`` (no index math), so that an iteration is
    one shared load and one add an element.  Returns
    :func:`gather_floor_plain`'s value.  CUDA tensors only."""
    x, idx = _gather_args("gather_floor_cuda", x, idx)
    out = torch.empty_like(x)
    GATHER_FLOOR_KERNEL(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[1], K, _stream(x))
    return out


def gather_floor_plain(x: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """``acc[r, n] = sum_{i<K} x[idx[r, n] mod 8, n]``, summed in order from 0."""
    row = torch.gather(x, 0, torch.remainder(idx, GATHER_ROWS).long())
    acc = torch.zeros_like(x)
    for _ in range(K):
        acc = acc + row
    return acc


def gather_floor_us(x: torch.Tensor, idx: torch.Tensor, Ks: Tuple[int, int] = (16, 48)
                    ) -> float:
    """Microseconds a gather that no design of one shared-memory load an
    element goes below: the slope of :func:`gather_floor_cuda` on (x, idx)
    between the two K."""
    return slope_us(lambda K: gather_floor_cuda(x, idx, K), *Ks)


def shared_pipe_us(N: int, device: torch.device) -> float:
    """Microseconds for 8 N shared loads over the card's SMs at
    :data:`SHARED_LOADS_PER_CLOCK` each a clock, at :data:`BOUND_CLOCK_HZ`
    (computed, not measured): the rate the gather's floor is read against."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return GATHER_ROWS * N / (sms * SHARED_LOADS_PER_CLOCK) / BOUND_CLOCK_HZ * 1e6


def gather(x: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """K grouped 8-row gathers: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    return dispatch("gather", x.device, gather_cuda, gather_plain, x, idx, K)


# ---- matmul: the rescore unit


def matmul_plain(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """``sum_{i<K} bf16(a + i) . b^T`` for f32 a (M, D) and bf16 b (N, D):
    each product in f32, added to the f32 sum in order."""
    bf = b.float()
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32, device=a.device)
    for i in range(K):
        acc = acc + (a + i).to(torch.bfloat16).float() @ bf.T
    return acc


def _matmul_args(name: str, a: torch.Tensor, b: torch.Tensor):
    _check_cuda(name, a, b)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected (M, D) and (N, D), got {tuple(a.shape)}, {tuple(b.shape)}")
    M, D = a.shape
    N = b.shape[0]
    if a.dtype != torch.float32 or b.dtype != torch.bfloat16 or b.shape != (N, D):
        raise ValueError(f"expected (M, D) float32 and (N, D) bfloat16, got {a.dtype} "
                         f"{tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")
    if N % MATMUL_TILE[1] or D % 16 or D > MATMUL_MAX_D:
        raise ValueError(f"{name} takes N % {MATMUL_TILE[1]} == 0 and D % 16 == 0, "
                         f"D <= {MATMUL_MAX_D}; got N={N}, D={D}")
    return a.contiguous(), b.contiguous(), M, N, D


def _matmul_scratch(M: int, N: int, device: torch.device):
    """The output, the blocks' partial sums and the tiles' zeroed counts."""
    tiles = -(-M // MATMUL_TILE[0]) * (N // MATMUL_TILE[1])
    return (torch.empty(M, N, dtype=torch.float32, device=device),
            torch.empty(tiles * MATMUL_SPLIT * MATMUL_TILE[0] * MATMUL_TILE[1],
                        dtype=torch.float32, device=device),
            torch.zeros(tiles, dtype=torch.int32, device=device))


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel (``wgmma`` bf16 with A from registers; each tile's
    dimensions split across 4 blocks of 2 warpgroups) on the same inputs as
    :func:`matmul_plain`."""
    a, b, M, N, D = _matmul_args("matmul_cuda", a, b)
    out, part, count = _matmul_scratch(M, N, a.device)
    MATMUL_KERNEL(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), count.data_ptr(),
                  M, N, D, K, _stream(a))
    return out


def matmul_occupancy(M: int, N: int, D: int, timed: bool = False) -> dict:
    """Registers a thread, resident blocks an SM, threads a block and the
    grid's blocks of the matmul kernel for (M, N, D) (of its stage-timed
    build where ``timed``), from the CUDA runtime."""
    out = (ctypes.c_int * 4)()
    err = MATMUL_OCCUPANCY(int(timed), M, N, D, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"qtt_matmul_occupancy failed: CUDA error {err}")
    return {"registers": out[0], "blocks_per_sm": out[1], "threads_per_block": out[2],
            "blocks": out[3]}


def _matmul_timed(a: torch.Tensor, b: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the stage-timed build: its output and its (blocks,
    len(MATMUL_STAGES) + 2) int64 buffer, without waiting for either."""
    a, b, M, N, D = _matmul_args("matmul_stages", a, b)
    out, part, count = _matmul_scratch(M, N, a.device)
    stages = torch.zeros(count.numel() * MATMUL_SPLIT, len(MATMUL_STAGES) + 2,
                         dtype=torch.int64, device=a.device)
    MATMUL_TIMED_KERNEL(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
                        count.data_ptr(), M, N, D, K, stages.data_ptr(), _stream(a))
    return out, stages


def matmul_stages(a: torch.Tensor, b: torch.Tensor, K: int) -> Tuple[torch.Tensor, dict]:
    """The stage-timed build of the matmul kernel on the same inputs as
    :func:`matmul_cuda`: the same output, and per stage of
    :data:`MATMUL_STAGES` its share of the warps' summed clock cycles and a
    warp's mean cycles an iteration (the stage's cycles over K, so the
    prologue's and the epilogue's one pass is spread over the K iterations;
    the slope between two K in :func:`stages_line` cancels it).  CUDA
    tensors only."""
    out, stages = _matmul_timed(a, b, K)
    occ = matmul_occupancy(a.shape[0], b.shape[0], a.shape[1], timed=True)
    st = stages.double().cpu()
    n = len(MATMUL_STAGES)
    cyc = st[:, :n].sum(0) / (st.shape[0] * (occ["threads_per_block"] // 32))
    return out, {
        "blocks": st.shape[0], "ghz": float(st[:, n].sum() / st[:, n + 1].sum()),
        "warp_cycles": {k: float(v) for k, v in zip(MATMUL_STAGES, cyc)},
        "share": {k: float(v) for k, v in zip(MATMUL_STAGES, cyc / cyc.sum())},
        "clocks_per_iteration": {k: float(v) / max(K, 1) for k, v in zip(MATMUL_STAGES, cyc)},
    }


def matmul(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """K rescore products: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    return dispatch("matmul", a.device, matmul_cuda, matmul_plain, a, b, K)


MATMUL_RTOL = 1e-5


def matmul_close(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 K: int) -> bool:
    """Whether two results of ``matmul`` differ by at most MATMUL_RTOL of
    the sum of |terms| (``sum_i |bf16(a + i)| . |b|^T``): the same products,
    summed in another order."""
    bf = b.float().abs()
    scale = sum((a + i).to(torch.bfloat16).float().abs() @ bf.T for i in range(K))
    return bool(((got - want).abs() <= MATMUL_RTOL * scale).all())


# ---- assembly: the fused score assembly


def assembly_plain(x: torch.Tensor, K: int) -> torch.Tensor:
    """K passes of ``acc <- ((acc - 2 col) + row) + 2 (acc - row)`` from
    ``acc = x``, with ``col = x[:, 0:1]`` and ``row = x[0:1, :]``."""
    col, row = x[:, 0:1], x[0:1, :]
    acc = x
    for _ in range(K):
        acc = ((acc - 2.0 * col) + row) + 2.0 * (acc - row)
    return acc


def assembly_cuda(x: torch.Tensor, K: int) -> torch.Tensor:
    """The kernel on the same inputs as :func:`assembly_plain`."""
    _check_cuda("assembly_cuda", x)
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"expected (rows, cs) float32, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    ASSEMBLY_KERNEL(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], K, _stream(x))
    return out


def assembly(x: torch.Tensor, K: int) -> torch.Tensor:
    """K assembly passes: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    return dispatch("assembly", x.device, assembly_cuda, assembly_plain, x, K)


# ---- the probes at the JAX script's shapes

ROWS = 1024
GATHER_N = 128 * 512
MATMUL_D, MATMUL_N = 512, 256
ASSEMBLY_CS = 256


@dataclass
class Probe:
    """One probe on its inputs: ``run(K)`` goes through the dispatcher,
    ``plain(K)`` is the plain version on the same inputs."""

    name: str
    label: str  # the JAX script's line
    unit: str
    Ks: Tuple[int, int]  # the two K of the slope
    inputs: Tuple[torch.Tensor, ...]
    run: Callable[[int], torch.Tensor]
    plain: Callable[[int], torch.Tensor]


def probes(device: torch.device) -> List[Probe]:
    """The four probes at the JAX script's shapes and K, on inputs drawn
    from a generator seeded with 0 with the script's distributions: uniform
    in [1, 2) for minround, in [0, 1) otherwise, and all-zero gather
    indexes."""
    gen = torch.Generator().manual_seed(0)

    def uniform(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    x1 = uniform(ROWS, LANES) + 1.0
    tbl, idx = uniform(GATHER_ROWS, GATHER_N), torch.zeros(GATHER_ROWS, GATHER_N,
                                                          dtype=torch.int32, device=device)
    a, b = uniform(ROWS, MATMUL_D), uniform(MATMUL_N, MATMUL_D).to(torch.bfloat16)
    xa = uniform(ROWS, ASSEMBLY_CS)
    return [
        Probe("minround", f"packed-min round ({ROWS},{LANES})", "us/round", (32, 96), (x1,),
              lambda K: minround(x1, K), lambda K: minround_plain(x1, K)),
        Probe("gather", f"8-row gather ({GATHER_ROWS},{GATHER_N}) f32", "us/gather", (16, 48),
              (tbl, idx), lambda K: gather(tbl, idx, K), lambda K: gather_plain(tbl, idx, K)),
        Probe("matmul", f"matmul ({ROWS},{MATMUL_D})x({MATMUL_D},{MATMUL_N}) bf16", "us/mm",
              (16, 48), (a, b), lambda K: matmul(a, b, K), lambda K: matmul_plain(a, b, K)),
        Probe("assembly", f"fused assembly pass ({ROWS},{ASSEMBLY_CS})", "us/pass", (32, 96),
              (xa,), lambda K: assembly(xa, K), lambda K: assembly_plain(xa, K)),
    ]


def slope_us(fn: Callable[[int], object], K1: int, K2: int, reps: int = 20) -> float:
    """Microseconds an iteration: the device time of ``fn(K2)`` less that
    of ``fn(K1)``, over ``K2 - K1`` (the JAX script's slope; the launch
    cost cancels)."""
    t1 = device_ms(lambda: fn(K1), reps)
    t2 = device_ms(lambda: fn(K2), reps)
    return (t2 - t1) / (K2 - K1) * 1e3


def stages_line(a: torch.Tensor, b: torch.Tensor, Ks: Tuple[int, int] = (16, 48)
                ) -> Tuple[str, dict]:
    """The ``[matmul stages]`` line for the matmul kernel on (a, b) at both
    K, and its numbers: the timed build's output must equal the shipped
    kernel's at each K (else this raises); each stage's share of the warps'
    cycles at each K and its clocks an iteration, a warp's cycles at K2
    less those at K1 over K2 - K1 (the slope, as the probe's time); the
    timed build's us an iteration beside the kernel's; registers and blocks
    an SM."""
    K1, K2 = Ks
    br = {}
    for K in Ks:
        got, br[K] = matmul_stages(a, b, K)
        if not torch.equal(got, matmul_cuda(a, b, K)):
            raise RuntimeError(
                f"the stage-timed matmul's output differs from the kernel's at K={K}")
    occ = matmul_occupancy(a.shape[0], b.shape[0], a.shape[1])
    slope = {k: (br[K2]["warp_cycles"][k] - br[K1]["warp_cycles"][k]) / (K2 - K1)
             for k in MATMUL_STAGES}
    out = {"by_K": {str(K): br[K] for K in Ks}, "clocks_per_iteration": slope,
           "ghz": br[K2]["ghz"], "blocks": br[K2]["blocks"], **occ,
           "timed_us": slope_us(lambda K: _matmul_timed(a, b, K), K1, K2),
           "kernel_us": slope_us(lambda K: matmul_cuda(a, b, K), K1, K2)}
    total = sum(slope.values())
    line = (f"[matmul stages] {out['blocks']} blocks, {out['ghz']:.3f} GHz, "
            f"{occ['registers']} registers, {occ['blocks_per_sm']} block(s) an SM of "
            f"{occ['threads_per_block'] // 32} warps; timed {out['timed_us']:.5f} us vs "
            f"{out['kernel_us']:.5f} us an iteration; " + "; ".join(
                f"K={K}: " + ", ".join(f"{k} {100 * br[K]['share'][k]:.1f}%"
                                       for k in MATMUL_STAGES) for K in Ks)
            + f"; a warp's clocks an iteration (K={K2} less K={K1}): " + ", ".join(
                f"{k} {slope[k]:.0f}" for k in MATMUL_STAGES) + f", total {total:.0f}")
    return line, out


def minround_floor_line(x: torch.Tensor, us: float, Ks: Tuple[int, int] = (32, 96)
                        ) -> Tuple[str, dict]:
    """The ``[floor minround]`` line for the minround kernel on ``x``, which
    takes ``us`` a round (its slope): its reduction-chain floor (measured
    here) and its fixed cost a call, the device time at the first K less
    that many rounds: work done once a call (the launch, the loads, the
    sort, the stores) lands there, where the slope does not see it.  The
    floor kernel's output must be each row's least key (else this raises)."""
    if not torch.equal(redux_chain_cuda(x, Ks[0]), row_least_key(x)):
        raise RuntimeError("the reduction chain's output differs from each row's least key")
    fixed = device_ms(lambda: minround_cuda(x, Ks[0]), 50) * 1e3 - Ks[0] * us
    out = {"floor_us": minround_floor_us(x, Ks), "fixed_us": fixed}
    line = (f"[floor minround] {tuple(x.shape)}: {us:.5f} us a round against a reduction-chain "
            f"floor of {out['floor_us']:.5f} us ({us / out['floor_us']:.2f}x); fixed cost "
            f"{out['fixed_us']:.3f} us a call at K={Ks[0]} (device time less {Ks[0]} rounds)")
    return line, out


def gather_floor_line(x: torch.Tensor, idx: torch.Tensor, us: float,
                      Ks: Tuple[int, int] = (16, 48)) -> Tuple[str, dict]:
    """The ``[floor gather]`` line for the gather kernel on (x, idx), which
    takes ``us`` a gather: its shared-load floor (measured here; the floor
    kernel's output must equal :func:`gather_floor_plain`'s, else this
    raises), beside the shared-memory pipe's computed rate."""
    if not torch.equal(gather_floor_cuda(x, idx, Ks[0]), gather_floor_plain(x, idx, Ks[0])):
        raise RuntimeError("the gather floor kernel's output differs from its plain version")
    N = x.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = {"floor_us": gather_floor_us(x, idx, Ks), "pipe_us": shared_pipe_us(N, x.device)}
    line = (f"[floor gather] ({GATHER_ROWS}, {N}): {us:.5f} us a gather against a shared-load "
            f"floor of {out['floor_us']:.5f} us ({us / out['floor_us']:.2f}x; the loads from "
            f"fixed rows, measured); the shared pipe's rate, {GATHER_ROWS * N} loads over {sms} "
            f"SMs x {SHARED_LOADS_PER_CLOCK} a clock at {BOUND_CLOCK_HZ / 1e9:.2f} GHz: "
            f"{out['pipe_us']:.5f} us (computed)")
    return line, out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("prim_bench: no CUDA device is available; the probes run only on a card",
              file=sys.stderr)
        return 2
    ps = probes(torch.device("cuda"))
    if "--stages" in argv:
        print(stages_line(*ps[2].inputs)[0], flush=True)
        print(nvidia_smi_line(), flush=True)
        return 0
    if "--floors" in argv:
        mr, ga = ps[0], ps[1]
        print(minround_floor_line(mr.inputs[0], slope_us(mr.run, *mr.Ks), mr.Ks)[0], flush=True)
        print(gather_floor_line(*ga.inputs, slope_us(ga.run, *ga.Ks), ga.Ks)[0], flush=True)
        print(nvidia_smi_line(), flush=True)
        return 0
    for p in ps:
        print(f"{p.label}: {slope_us(p.run, *p.Ks):9.4f} {p.unit}", flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
