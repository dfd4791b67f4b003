"""Throughput probe: a chain of serially dependent rescore steps with the
candidate errors E kept in bf16, and the same chain with E in int8.

Counterpart of ``experiments/int8_mxu_probe.py``.  At the seqbeam rescore
shape, E (2048, 512) against the codebook c (256, 512), each of 24 steps
runs two products, ``cross = E c^T`` and ``upd = cross' c``, and folds
``upd`` back into E, so no step can start before the last one ends.  Each
chain is one launch of a hand-written kernel (``csrc/int8_mxu_probe.cu``),
after, for "bf16", a prologue that splits c:

- the "bf16" chain: E is held in bf16, but c stays f32, as in the JAX
  kernel (its mixed ``dot_general`` keeps the f32 operand in f32): ``cross
  = f32(bf16 E) c^T``, ``upd = (f32(bf16 cross) c) * 1e-6``, ``E <-
  bf16(f32(E) + upd)``.  The kernel splits c exactly into three bf16 parts
  (:func:`bf16_split`) and runs each product as three bf16 products on the
  tensor cores, every term exact in f32 (:func:`bf16_chain_split_model` is
  that arithmetic in plain PyTorch), in pairs of blocks that each take
  half of the split c;
- the int8 chain: E as int8 with per-row f32 scales, requantized every
  step, c as ``round(c * 127)`` saturated to int8; the second product's
  left side is ``round(cross / max|cross| * 127)`` with the max over the
  WHOLE (2048, 256) matrix, taken in the middle of every step, so the kernel is one
  cooperative launch with a grid-wide barrier per step.  Blocks of 16 rows
  run both products on int8 ``wgmma``, with c8 held in both K-major layouts
  (shared memory and registers); the barrier is a slot a block carrying a
  fresh tag and the block's max.  Its stage-timed build
  (:func:`int8_chain_stages`, its own entry point and count) and the
  barrier alone (:func:`int8_barrier_floor`) say where a step's time goes.

A division by the constant 127 is a product with f32(1/127), as XLA
rewrites it; a division by a tensor is a true IEEE division; rounding is
half to even.  Each chain has a plain PyTorch version (``*_plain``) and the
kernel (``*_cuda``); the dispatcher runs the kernel on a CUDA tensor and
the plain version on a CPU tensor.

Run on the card:  python -m quantization_tpu_torch.experiments.int8_mxu_probe [--stages]
(``--stages``: the int8 chain's ``[int8_chain stages]`` line and its barrier
floor in place of the chains' times)
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops.cuda_build import CFunction, CudaKernel
from ..utils.device import device_ms, dispatch, nvidia_smi_line

MB, D, CS = 2048, 512, 256
STEPS = 24  # nc steps x 3 passes at the flagship
INV127 = float(np.float32(1.0) / np.float32(127.0))
MAX_D, MAX_CS = 512, 256  # the widths the kernels' shared memory holds

BF16_CHAIN_KERNEL = CudaKernel("int8_mxu_probe", "qtt_bf16_chain_launch",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# bytes of the split c's scratch for (D, CS)
SPLIT_BYTES = CFunction("int8_mxu_probe", "qtt_bf16_chain_split_bytes", [ctypes.c_int] * 2)
# the int8 chain: e, c, img, slots, out, MB, D, CS, steps, tag0, stream
INT8_CHAIN_KERNEL = CudaKernel(
    "int8_mxu_probe", "qtt_int8_chain_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_void_p])
KERNELS = {"bf16_chain": BF16_CHAIN_KERNEL, "int8_chain": INT8_CHAIN_KERNEL}
# the int8 chain's stage-timed build: the launch's arguments, then the stage buffer
INT8_CHAIN_TIMED_KERNEL = CudaKernel(
    "int8_mxu_probe", "qtt_int8_chain_timed_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_uint32] + [ctypes.c_void_p] * 2)
# the chain's grid barriers with no other work (the barrier floor): slots,
# out, MB, steps, tag0, stream
INT8_BARRIER_KERNEL = CudaKernel(
    "int8_mxu_probe", "qtt_int8_barrier_floor_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_uint32, ctypes.c_void_p])
INT8_OCCUPANCY = CFunction("int8_mxu_probe", "qtt_int8_chain_occupancy",
                           [ctypes.c_int, ctypes.c_void_p])
# the timed build's stages, in the order of its buffer's columns
INT8_STAGES = ("prod1", "bmax", "gsync", "quant", "prod2", "requant")


# operations of a chain's products as the JAX script counts them (:116):
# two products a step, two operations a multiply-add
FLOPS = 2.0 * STEPS * 2 * MB * D * CS


def bf16_chain_plain(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The "bf16" chain in plain PyTorch: f32 products of f32(bf16) values
    and f32 c (on a card, with TF32 off, PyTorch's default)."""
    eb = e.to(torch.bfloat16)
    for _ in range(steps):
        cross = eb.float() @ c.T
        upd = (cross.to(torch.bfloat16).float() @ c) * 1e-6
        eb = (eb.float() + upd).to(torch.bfloat16)
    return eb.float()


def bf16_split(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's split of f32 ``c`` into three bf16 parts, by
    round-to-nearest of successive remainders: ``hi = bf16(c)``, ``mid =
    bf16(c - hi)``, ``lo = bf16(c - hi - mid)``.  Each remainder is exact in
    f32, and ``(hi + mid) + lo == c`` for a normal c whose last bit lies
    above bf16's smallest denormal (8 + 8 + 8 bits of significand)."""
    hi = c.to(torch.bfloat16)
    r1 = c - hi.float()
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.float()).to(torch.bfloat16)


def bf16_chain_split_model(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: each product of the "bf16"
    chain as three products of bf16-exact operands, one a part of c, each
    summed apart and then (hi + mid) + lo in f32; it differs from
    :func:`bf16_chain_plain` only in the order of the f32 sums."""
    parts = [p.float() for p in bf16_split(c)]
    eb = e.to(torch.bfloat16)
    for _ in range(steps):
        ef = eb.float()
        cross = (ef @ parts[0].T + ef @ parts[1].T) + ef @ parts[2].T
        cb = cross.to(torch.bfloat16).float()
        upd = ((cb @ parts[0] + cb @ parts[1]) + cb @ parts[2]) * 1e-6
        eb = (ef + upd).to(torch.bfloat16)
    return eb.float()


def round_to_int8(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded half to even and converted to int8 as
    ``jnp.round(x).astype(jnp.int8)`` converts: saturated to [-128, 127] (a
    bare ``.to(torch.int8)`` keeps the low byte, so 200 would give -56), NaN
    to 0."""
    return torch.clamp(torch.round(x), -128, 127).to(torch.int8)


def _requant(ef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization: scale max|row| * f32(1/127), values
    round(ef / scale) half to even."""
    s = ef.abs().amax(dim=1, keepdim=True) * INV127
    return torch.round(ef / s).to(torch.int8), s


def _int_product(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """An int8 x int8 -> int32 product as f32: float64 sums of int8 values
    are exact (|sum| < 2^53), and so is their f32 value below 2^24."""
    return (a8.double() @ b8.double()).float()


def int8_chain_plain(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The int8 chain in plain PyTorch, step for step the JAX kernel's
    arithmetic; every integer product is exact, so the kernel equals it."""
    ef = e
    e8, s = _requant(ef)
    c8 = round_to_int8(c * 127.0)
    for _ in range(steps):
        cross = (_int_product(e8, c8.T) * s) * INV127
        q8 = round_to_int8(cross / cross.abs().max() * 127.0)
        upd = _int_product(q8, c8) * 1e-9
        ef = e8.float() * s + upd
        e8, s = _requant(ef)
    return ef


def _chain_args(name: str, e: torch.Tensor, c: torch.Tensor):
    dev = e.device
    if not (e.is_cuda and c.device == dev):
        raise ValueError(f"{name} needs both tensors on one CUDA device")
    mb, d = e.shape
    cs = c.shape[0]
    if e.dtype != torch.float32 or c.dtype != torch.float32 or c.shape != (cs, d):
        raise ValueError(f"expected (MB, D) and (CS, D) float32, got {e.dtype} "
                         f"{tuple(e.shape)}, {c.dtype} {tuple(c.shape)}")
    if d % 64 or cs % 64 or d > MAX_D or cs > MAX_CS:
        raise ValueError(f"{name} takes D and CS multiples of 64 up to {MAX_D} and {MAX_CS}; "
                         f"got D={d}, CS={cs}")
    # the kernels read rows as 16-byte vectors
    e, c = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (e, c))
    return e, c, mb, d, cs, torch.cuda.current_stream(dev).cuda_stream


def bf16_chain_cuda(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The kernel on the same inputs as :func:`bf16_chain_plain`: the split
    of c into a scratch buffer, then the chain, in pairs of blocks of 32
    rows."""
    e, c, mb, d, cs, stream = _chain_args("bf16_chain_cuda", e, c)
    out = torch.empty_like(e)
    split = torch.empty(SPLIT_BYTES(d, cs), dtype=torch.uint8, device=e.device)
    BF16_CHAIN_KERNEL(e.data_ptr(), c.data_ptr(), split.data_ptr(), out.data_ptr(), mb, d, cs,
                      steps, stream)
    return out


def int8_chain_cuda(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The kernel on the same inputs as :func:`int8_chain_plain`: one
    cooperative launch of blocks of 16 rows, with c8's image (CS x D bytes)
    as scratch; every block must be resident at once, so MB is at most 16
    rows a block times the blocks the card holds (one an SM: 2,112 rows on
    132 SMs), else the launch fails and this raises."""
    return _int8_launch("int8_chain_cuda", INT8_CHAIN_KERNEL, e, c, steps)


ROWS_PER_BLOCK = 16
# per (device, stream): the grid barriers' slots (two 64-bit words a block,
# zeroed once) and the next unused tag; each launch takes a tag a barrier,
# so a slot never holds a tag that a later launch waits for
_BARRIERS: Dict[Tuple[int, int], list] = {}
_TAG_LIMIT = 2 ** 32


def _barrier(device: torch.device, stream: int, mb: int, barriers: int) -> Tuple[int, int]:
    """The slots' address and the first tag for a launch of ``barriers``
    grid barriers on ``mb`` rows."""
    blocks = -(-mb // ROWS_PER_BLOCK)
    key = (device.index, stream)
    entry = _BARRIERS.get(key)
    if entry is None or entry[0].numel() < 2 * blocks or entry[1] + barriers >= _TAG_LIMIT:
        entry = _BARRIERS[key] = [torch.zeros(2 * blocks, dtype=torch.int64, device=device), 1]
    tag = entry[1]
    entry[1] += barriers
    return entry[0].data_ptr(), tag


def _int8_launch(name: str, kernel: CudaKernel, e: torch.Tensor, c: torch.Tensor, steps: int,
                 *extra) -> torch.Tensor:
    e, c, mb, d, cs, stream = _chain_args(name, e, c)
    if torch.cuda.is_current_stream_capturing():
        # a replay would wait for the captured tags, which the slots
        # already hold from the last replay, and pass with stale maxima
        raise RuntimeError(f"{name} cannot be captured in a CUDA graph: each launch "
                           "takes fresh barrier tags from the host")
    out = torch.empty_like(e)
    img = torch.empty(cs * d, dtype=torch.uint8, device=e.device)  # c8, row-major
    # barrier 0 publishes c8's image, barrier 1 + s is step s's max
    slots, tag = _barrier(e.device, stream, mb, steps + 1)
    kernel(e.data_ptr(), c.data_ptr(), img.data_ptr(), slots, out.data_ptr(), mb, d, cs, steps,
           tag, *extra, stream)
    return out


def int8_chain_stages(e: torch.Tensor, c: torch.Tensor,
                      steps: int = STEPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage-timed build of the int8 chain on the same inputs as
    :func:`int8_chain_cuda`: the same output, and a (blocks,
    len(INT8_STAGES) + 2) int64 tensor holding, per block, the ``clock64()``
    cycles of each of :data:`INT8_STAGES` summed over the block's warps,
    then the longest warp's own cycles and nanoseconds.  CUDA tensors
    only."""
    if not (e.is_cuda and c.is_cuda):
        raise ValueError("int8_chain_stages needs CUDA tensors")
    blocks = -(-e.shape[0] // ROWS_PER_BLOCK)
    stages = torch.zeros(blocks, len(INT8_STAGES) + 2, dtype=torch.int64, device=e.device)
    out = _int8_launch("int8_chain_stages", INT8_CHAIN_TIMED_KERNEL, e, c, steps,
                       stages.data_ptr())
    return out, stages


def int8_barrier_floor(mb: int, device: torch.device, steps: int = STEPS) -> torch.Tensor:
    """The chain's grid for ``mb`` rows running ``steps`` of its grid
    barriers, each with the block maxima the chain takes there and no
    other work; returns each step's max, which must be the largest block
    index plus the step."""
    out = torch.empty(max(steps, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    slots, tag = _barrier(device, stream, mb, steps)
    INT8_BARRIER_KERNEL(slots, out.data_ptr(), mb, steps, tag, stream)
    return out[:steps]


def int8_chain_occupancy(timed: bool = False) -> dict:
    """Registers a thread, threads a block and resident blocks an SM of the
    int8 chain's kernel (of its stage-timed build where ``timed``)."""
    out = (ctypes.c_int * 3)()
    err = INT8_OCCUPANCY(int(timed), ctypes.addressof(out))
    if err:
        raise RuntimeError(f"qtt_int8_chain_occupancy failed: CUDA error {err}")
    return {"registers": out[0], "blocks_per_sm": out[1], "threads_per_block": out[2]}


def int8_stage_breakdown(stages: torch.Tensor, steps: int, threads: int) -> dict:
    """Per stage of the timed build, its share of the warps' summed cycles
    and its microseconds a block-step (a warp's mean cycles a step at the
    clock rate that the blocks' own cycles over their nanoseconds give), and
    the blocks' mean lifetime from their first step on, in microseconds."""
    st = stages.double().cpu()
    n = len(INT8_STAGES)
    warps = threads // 32
    ghz = float(st[:, n].sum() / st[:, n + 1].sum())
    cyc = st[:, :n].sum(0)
    us = cyc / (st.shape[0] * warps * max(steps, 1) * ghz * 1e3)
    return {
        "blocks": st.shape[0], "ghz": ghz,
        "share": {k: float(v) for k, v in zip(INT8_STAGES, cyc / cyc.sum())},
        "us_per_block_step": {k: float(v) for k, v in zip(INT8_STAGES, us)},
        "steps_us": float(st[:, n + 1].mean() / 1e3),
    }


def bf16_chain(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The "bf16" chain: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    return dispatch("bf16_chain", e.device, bf16_chain_cuda, bf16_chain_plain, e, c, steps)


def int8_chain(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The int8 chain: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    return dispatch("int8_chain", e.device, int8_chain_cuda, int8_chain_plain, e, c, steps)


BF16_MIN_EQUAL = 0.9999


def bf16_chain_agreement(got: torch.Tensor, want: torch.Tensor, e: torch.Tensor) -> dict:
    """How a "bf16" chain result ``got`` agrees with the plain ``want`` on
    input ``e``.  Only the order of the f32 sums differs, so: at least
    BF16_MIN_EQUAL of the elements equal and the rest within one bf16 ulp.
    upd (about 1e-6) is far below a bf16 ulp at |e| ~ 1, so the chain
    leaves most elements at bf16(e): the elements it changes must exist
    (``changed`` > 0) and be equal in both, or a kernel that skipped the
    chain would pass."""
    def bits(t):
        return t.to(torch.bfloat16).view(torch.int16).int()

    start = e.to(torch.bfloat16).float()
    changed = want != start
    eq = got == want
    ulps = int((bits(got) - bits(want)).abs().max()) if got.numel() else 0
    out = {"equal_frac": float(eq.float().mean()), "max_ulps": ulps,
           "changed": int(changed.sum()), "changed_equal": bool(eq[changed].all()),
           "max_abs_err": float((got - want).abs().max())}
    out["ok"] = (out["equal_frac"] >= BF16_MIN_EQUAL and ulps <= 1 and out["changed"] > 0
                 and out["changed_equal"])
    return out


# an f32 sum in any order within this many ulps of the sum of |terms| (the
# kernel's and the plain version's products differ only in their order)
SUM_ULPS = 4


def _f32_toward(x: torch.Tensor, up: bool) -> torch.Tensor:
    """float64 ``x`` rounded to f32 up or down."""
    v = x.float()
    off = v.double() < x if up else v.double() > x
    return torch.where(off, torch.nextafter(v, torch.full_like(v, np.inf if up else -np.inf)), v)


def bf16_step_bounds(e: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least and the most one step of the "bf16" chain can give on
    ``e`` when each of its f32 products lies within SUM_ULPS ulps of the sum
    of |terms| of the exact product, as a sum in any order does: cross at
    either end of its interval, rounded to bf16 either way between them,
    then upd's interval over those, folded into E with the chain's f32
    roundings.  Every rounding is monotone, so one step of the plain
    version or of the kernel lies elementwise in the returned (lo, hi)."""
    u = SUM_ULPS * 2.0 ** -24
    ef = e.to(torch.bfloat16).double()
    cd, ca = c.double(), c.double().abs()
    cross = ef @ cd.T
    t1 = u * (ef.abs() @ ca.T)
    cb_lo = _f32_toward(cross - t1, False).to(torch.bfloat16).double()
    cb_hi = _f32_toward(cross + t1, True).to(torch.bfloat16).double()
    mid, half = (cb_lo + cb_hi) / 2, (cb_hi - cb_lo) / 2
    t2 = half @ ca + u * (torch.maximum(cb_lo.abs(), cb_hi.abs()) @ ca)
    upd = mid @ cd
    ef32 = ef.float()

    def fold(v):
        return (ef32 + v * 1e-6).to(torch.bfloat16).float()

    return fold(_f32_toward(upd - t2, False)), fold(_f32_toward(upd + t2, True))


@dataclass
class Chain:
    """One chain on its inputs: ``run()`` goes through the dispatcher,
    ``plain()`` is the plain version on the same inputs."""

    name: str
    label: str  # the JAX script's tag
    inputs: Tuple[torch.Tensor, torch.Tensor]
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]


def chains(device: torch.device) -> List[Chain]:
    """The two chains at the JAX script's shape on inputs drawn from a
    generator seeded with 0 with its distributions: E normal, c normal x
    0.05."""
    gen = torch.Generator().manual_seed(0)
    e = torch.randn(MB, D, generator=gen).to(device)
    c = (torch.randn(CS, D, generator=gen) * 0.05).to(device)
    return [
        Chain("bf16_chain", "bf16xbf16->f32 (E in bf16, c in f32)", (e, c),
              lambda: bf16_chain(e, c), lambda: bf16_chain_plain(e, c)),
        Chain("int8_chain", "int8xint8->int32 (+requant VPU)", (e, c),
              lambda: int8_chain(e, c), lambda: int8_chain_plain(e, c)),
    ]


def stages_line(e: torch.Tensor, c: torch.Tensor) -> Tuple[str, dict]:
    """The ``[int8_chain stages]`` line for the chain on (e, c), and its
    numbers: the timed build's output must equal the shipped kernel's (else
    this raises); each stage's share and us a block-step, the timed build's
    ms beside the kernel's, registers and blocks an SM, and the barrier
    floor: the chain's grid running its STEPS barriers and nothing else."""
    got, stages = int8_chain_stages(e, c)
    if not torch.equal(got, int8_chain_cuda(e, c)):
        raise RuntimeError("the stage-timed int8 chain's output differs from the kernel's")
    occ = int8_chain_occupancy()
    b = int8_stage_breakdown(stages, STEPS, occ["threads_per_block"])
    b.update(occ)
    b["timed_ms"] = device_ms(lambda: int8_chain_stages(e, c), 20)
    b["kernel_ms"] = device_ms(lambda: int8_chain_cuda(e, c), 20)
    floor = int8_barrier_floor(e.shape[0], e.device)
    blocks = -(-e.shape[0] // ROWS_PER_BLOCK)
    if not torch.equal(floor.cpu(), torch.arange(STEPS, dtype=torch.float32) + blocks - 1):
        raise RuntimeError(f"the barrier floor's maxima are wrong: {floor.tolist()}")
    b["barrier_floor_ms"] = device_ms(lambda: int8_barrier_floor(e.shape[0], e.device), 20)
    line = (f"[int8_chain stages] {b['blocks']} blocks, {b['ghz']:.3f} GHz, "
            f"{b['registers']} registers, {b['blocks_per_sm']} block(s) an SM; timed "
            f"{b['timed_ms']:.4f} ms vs {b['kernel_ms']:.4f} ms: " + ", ".join(
                f"{k} {100 * b['share'][k]:.1f}% {b['us_per_block_step'][k]:.3f}"
                for k in INT8_STAGES)
            + f" us a block-step, total {sum(b['us_per_block_step'].values()):.3f} (the blocks' "
            f"steps {b['steps_us']:.2f} us of the timed build's {b['timed_ms'] * 1e3:.2f}); "
            f"barrier floor ({STEPS} barriers) {b['barrier_floor_ms']:.4f} ms")
    return line, b


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("int8_mxu_probe: no CUDA device is available; the probes run only on a card",
              file=sys.stderr)
        return 2
    chs = chains(torch.device("cuda"))
    if "--stages" in argv:
        print(stages_line(*chs[1].inputs)[0], flush=True)
        print(nvidia_smi_line(), flush=True)
        return 0
    for ch in chs:
        ms = device_ms(ch.run, 50)
        print(f"{ch.label}: {ms:.3f} ms/chain  {FLOPS / (ms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
    # one step where it changes many elements: a quarter of E's scaled by 1e-5
    gen = torch.Generator().manual_seed(50)
    e = torch.randn(1000, D, generator=gen)
    e = torch.where(torch.rand(e.shape, generator=gen) < 0.25, e * 1e-5, e).cuda()
    c = chs[0].inputs[1]
    got, lo_hi = bf16_chain_cuda(e, c, 1), bf16_step_bounds(e, c)
    print(f"the bf16 chain, one step on E (1000, {D}) with a quarter of its elements x 1e-5: "
          f"{int((got != e.to(torch.bfloat16).float()).sum())} elements changed, "
          f"{int(((got < lo_hi[0]) | (got > lo_hi[1])).sum())} outside the bounds of sums within "
          f"{SUM_ULPS} ulps, {int((got != bf16_chain_plain(e, c, 1)).sum())} unequal to plain",
          flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
