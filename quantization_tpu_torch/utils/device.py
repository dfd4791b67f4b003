"""What a measurement records about the card it ran on."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

# cycles a second of the SM clock used to size the stream hold below; the
# H100's top clock is 1.98 GHz, so this overestimates the hold a little
_HOLD_CYCLES_PER_S = 2.0e9
_MAX_HOLD_S = 0.2  # enqueueing that takes longer keeps the card busy by itself


def device_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls on the
    current CUDA stream.

    The calls are timed with CUDA events around the run.  A short launch
    costs the host more time to enqueue (ctypes, allocation) than the card
    takes to run it, so the stream is first held by a spin kernel
    (``torch.cuda._sleep``) for twice the host's time to enqueue them: the
    card then runs them back to back, and the events time the card, not the
    host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * enqueue_s, _MAX_HOLD_S) * _HOLD_CYCLES_PER_S) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``name, power.limit``) for GPU 0.  A card set below its maximum power
    runs slower under load, so every number kept carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_record() -> dict:
    """Name, count and power limit of the CUDA cards, for a results file."""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }


def dispatch(name: str, device: torch.device, cuda: Callable, plain: Callable, *args):
    """``cuda(*args)`` when the inputs lie on a CUDA ``device``,
    ``plain(*args)`` when they lie on the CPU: a kernel's wrapper never
    falls back to its plain version."""
    if device.type == "cuda":
        return cuda(*args)
    if device.type == "cpu":
        return plain(*args)
    raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain) tensors, not {device}")
