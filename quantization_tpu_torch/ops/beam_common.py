"""The beam code both search kernels share, K2 (``ops/seqbeam.py``) and K3
(``ops/gramv3.py``), and the :class:`SearchKernel` that describes each."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core import search as _search
from ..core.types import QuantizerConfig, QuantizerParams
from .cuda_build import CudaKernel
from .logits_argmax import logits_argmax
from .tables_cache import TablesCache

LANE_BITS = 8
LANE_MASK = (1 << LANE_BITS) - 1
MAX_PASSES = 64


def packed_keys(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Packed selection keys as int32: the score clamped at 0 with its 8 low
    mantissa bits replaced by ``ids``.  Non-negative float bit patterns order
    like the values, so the smallest key is the smallest (truncated) score,
    lowest id on ties."""
    bits = torch.where(s > 0, s, torch.zeros_like(s)).view(torch.int32)
    return (bits & ~LANE_MASK) | ids


def as_float(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.float32)


def normalize_pool_mask(pool_mask, nc: int, passes: int):
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
    pm = normalize_pool_mask(pool_mask, nc, passes)
    if pm is None:
        return ((1 << nc) - 1,) * passes
    return tuple(sum(1 << t for t in range(nc) if m[t]) for m in pm)


def initial_indexes(params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor,
                    init_indexes: Optional[torch.Tensor] = None,
                    init_precision: str = "highest") -> torch.Tensor:
    """(B, nc) int32 initial indexes of (B, dim) f32 frames: the caller's
    ``init_indexes`` (shape and range checked, one host sync), or the logits
    argmax in f32 ("highest") or of bf16-rounded operands with f32 sums
    ("default", the TPU's single-pass matmul), lowest index on ties.
    "highest" on the card is one kernel (``ops/logits_argmax.py``:
    split-TF32 products, f32-faithful); on the CPU it is
    ``compute_logits``' argmax."""
    if init_indexes is not None:
        idx0 = init_indexes.to(device=x.device, dtype=torch.int32).contiguous()
        if idx0.shape != (x.shape[0], config.num_codebooks) or bool(
                ((idx0 < 0) | (idx0 >= config.codebook_size)).any()):
            raise ValueError("init_indexes must be (B, nc) codeword ids in [0, codebook_size)")
        return idx0
    if init_precision == "highest":
        if x.is_cuda:
            return logits_argmax(params, config, x)
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


def on_one_device(name: str, x: torch.Tensor, *tensors) -> None:
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError(f"{name} needs all tensors on one device")


@dataclasses.dataclass(frozen=True, eq=False)
class SearchKernel:
    """A search kernel as its consumers reach it: ``name`` is its
    ``search_method`` and span prefix; ``problem(params, config, x, passes=,
    **beam)`` builds what ``cuda`` (the card) and ``plain`` search; ``entry``
    counts its launches; ``encode``, its public wrapper, resolves the module
    attribute at each call, so that a patch of it is seen."""

    name: str
    supported: Callable[[QuantizerConfig], bool]
    problem: Callable
    cuda: Callable
    plain: Callable
    entry: CudaKernel
    tables: TablesCache
    encode: Callable
