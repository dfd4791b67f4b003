"""Throughput probe: a chain of serially dependent rescore steps with the
candidate errors E kept in bf16, and the same chain with E in int8.

Counterpart of ``experiments/int8_mxu_probe.py``.  At the seqbeam rescore
shape, E (2048, 512) against the codebook c (256, 512), each of 24 steps
runs two products, ``cross = E c^T`` and ``upd = cross' c``, and folds
``upd`` back into E, so no step can start before the last one ends.  Each
chain is one launch of a hand-written kernel (``csrc/int8_mxu_probe.cu``):

- the "bf16" chain: E is held in bf16, but c stays f32, as in the JAX
  kernel (its mixed ``dot_general`` keeps the f32 operand in f32): ``cross
  = f32(bf16 E) c^T``, ``upd = (f32(bf16 cross) c) * 1e-6``, ``E <-
  bf16(f32(E) + upd)``.  The kernel runs these products as f32 FMAs;
- the int8 chain: E as int8 with per-row f32 scales, requantized every
  step, c as ``round(c * 127)``; the second product's left side is
  ``round(cross / max|cross| * 127)`` with the max over the WHOLE (2048,
  256) matrix, taken in the middle of every step, so the kernel is one
  cooperative launch with a grid-wide barrier per step.

A division by the constant 127 is a product with f32(1/127), as XLA
rewrites it; a division by a tensor is a true IEEE division; rounding is
half to even.  Each chain has a plain PyTorch version (``*_plain``) and the
kernel (``*_cuda``); the dispatcher runs the kernel on a CUDA tensor and
the plain version on a CPU tensor.

Run on the card:  python -m quantization_tpu_torch.experiments.int8_mxu_probe
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops.cuda_build import CudaKernel
from ..utils.device import device_ms, dispatch, nvidia_smi_line

MB, D, CS = 2048, 512, 256
STEPS = 24  # nc steps x 3 passes at the flagship
INV127 = float(np.float32(1.0) / np.float32(127.0))
MAX_D, MAX_CS = 512, 256  # the widths the kernels' shared memory holds

BF16_CHAIN_KERNEL = CudaKernel(
    "int8_mxu_probe", "qtt_bf16_chain_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
INT8_CHAIN_KERNEL = CudaKernel(
    "int8_mxu_probe", "qtt_int8_chain_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
KERNELS = {"bf16_chain": BF16_CHAIN_KERNEL, "int8_chain": INT8_CHAIN_KERNEL}


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
    c8 = torch.round(c * 127.0).to(torch.int8)
    for _ in range(steps):
        cross = (_int_product(e8, c8.T) * s) * INV127
        q8 = torch.round(cross / cross.abs().max() * 127.0).to(torch.int8)
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
    return e.contiguous(), c.contiguous(), mb, d, cs, torch.cuda.current_stream(dev).cuda_stream


def bf16_chain_cuda(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The kernel on the same inputs as :func:`bf16_chain_plain`."""
    e, c, mb, d, cs, stream = _chain_args("bf16_chain_cuda", e, c)
    out = torch.empty_like(e)
    BF16_CHAIN_KERNEL(e.data_ptr(), c.data_ptr(), out.data_ptr(), mb, d, cs, steps, stream)
    return out


def int8_chain_cuda(e: torch.Tensor, c: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The kernel on the same inputs as :func:`int8_chain_plain`: one
    cooperative launch; every block must be resident at once, so MB is at
    most 16 rows a block times the blocks the card holds (2,112 rows on 132
    SMs), else the launch fails and this raises."""
    e, c, mb, d, cs, stream = _chain_args("int8_chain_cuda", e, c)
    out = torch.empty_like(e)
    # one slot a step for the bits of max|cross|, zeroed before the launch
    gmax = torch.zeros(max(steps, 1), dtype=torch.int32, device=e.device)
    INT8_CHAIN_KERNEL(e.data_ptr(), c.data_ptr(), gmax.data_ptr(), out.data_ptr(), mb, d, cs,
                      steps, stream)
    return out


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


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_mxu_probe: no CUDA device is available; the probes run only on a card",
              file=sys.stderr)
        return 2
    for ch in chains(torch.device("cuda")):
        ms = device_ms(ch.run, 50)
        print(f"{ch.label}: {ms:.3f} ms/chain  {FLOPS / (ms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
