"""Encode / decode and uint8 byte packing.

PyTorch counterpart of ``quantization_tpu/core/codec.py``
(`quantization/quantization.py:117-148, 244-275, 551-573`).
"""

from __future__ import annotations

import collections
import re
import threading

import torch

from ..utils.spans import span
from . import search
from .types import QuantizerConfig, QuantizerParams, scaled_centers


def pack_indexes(indexes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """Pack (..., nc) indexes into uint8 bytes, combining pairs of codebooks
    while codebook_size**2 <= 256 (`quantization/quantization.py:266-272`).
    The packed value is sum_j cs**j * idx_j over the group."""
    cs = codebook_size
    indexes = indexes.to(torch.int32)
    while cs ** 2 <= 256:
        indexes = indexes[..., 0::2] + cs * indexes[..., 1::2]
        cs = cs ** 2
    return indexes.to(torch.uint8)


def unpack_indexes(
    packed: torch.Tensor, codebook_size: int, num_codebooks: int
) -> torch.Tensor:
    """Inverse of :func:`pack_indexes`; accepts a last dim of num_codebooks
    (no-op), or num_codebooks / {2,4,8,16} (packed)
    (`quantization/quantization.py:551-573`)."""
    n = packed.shape[-1]
    packed = packed.to(torch.int32)
    if n == num_codebooks:
        return packed
    num_repeats = num_codebooks // n
    if num_repeats not in (2, 4, 8, 16) or n * num_repeats != num_codebooks:
        raise ValueError(f"cannot unpack width {n} into {num_codebooks} codebooks")
    powers = codebook_size ** torch.arange(num_repeats, dtype=torch.int32, device=packed.device)
    expanded = torch.div(packed[..., None], powers, rounding_mode="floor") % codebook_size
    return expanded.reshape(*packed.shape[:-1], num_codebooks)


# the rungs auto has taken, by name, one count an encode call ("beam" where
# it ran the exact beam): how often each rung engages in this process
AUTO_RUNGS: collections.Counter = collections.Counter()
_AUTO_RUNGS_LOCK = threading.Lock()
# auto's Gram-table rung (K3, ops/gramv3.py) by (dim, num_codebooks), put
# ahead of the seqbeam rungs where the card's guard rows hold it within the
# bar and it encodes faster end to end: the beam of the seqbeam rung beside
# it (M=8, R=4, altparity, as many passes) with the Gram table in place of
# the per-candidate error.  d256 / 4 B has none: its K2 rung runs 2 passes
_GRAMV3_RUNGS = {
    (512, 8): ("gramv3_bf16_alt3_d512!", 3,
               dict(M=8, R=4, pool_mask="altparity", g_dtype="bf16")),
    (1280, 8): ("gramv3_bf16_alt3_d1280!", 3,
                dict(M=8, R=4, pool_mask="altparity", g_dtype="bf16")),
}
# the fewest frames a call takes the Gram-table rung for: below them the
# seqbeam rung encodes as fast or faster end to end on the H100 (whole
# calls, experiments/rung_times.py; d512: K2 faster up to 1,024 frames, K3
# from 1,536; d1280: even at 512, K3 from 768)
GRAMV3_MIN_FRAMES = {(512, 8): 1536, (1280, 8): 768}


def _auto_candidates(config: QuantizerConfig):
    """The auto search's candidates in throughput order, each tied to its
    smoke-gate / quality-guard name (a trailing "!" marks candidates that
    also REQUIRE a measured quality entry): a Gram-table rung first where
    one is measured for ``(dim, num_codebooks)`` (:data:`_GRAMV3_RUNGS`),
    then the seqbeam rungs, the JAX package's ladder
    (``quantization_tpu/core/codec.py:118-145``) up to dim 1024 and d1280 /
    8 B's rungs of its own, measured on its own quantizer.  No other
    configuration above dim 1024 has a measured rung: it runs the exact
    beam."""
    gram = _GRAMV3_RUNGS.get((config.dim, config.num_codebooks))
    return ([gram] if gram else []) + _seqbeam_candidates(config)


def _seqbeam_candidates(config: QuantizerConfig):
    if config.dim == 256 and config.num_codebooks == 4:
        return [
            ("seqbeam_hl_d256", 2,
             dict(M=8, R=4, pool_mask="altparity", block_b=256,
                  interleave=2, reorder="select", e_dtype="bf16")),
        ]
    if config.dim == 1280 and config.num_codebooks == 8:
        return [
            ("seqbeam_int8e_d1280!", 3,
             dict(M=8, R=4, pool_mask="altparity", block_b=512,
                  interleave=2, reorder="select", e_dtype="int8", zip_skew=1)),
            ("seqbeam_hl_d1280", 3,
             dict(M=8, R=4, pool_mask="altparity", block_b=256,
                  interleave=2, reorder="select", e_dtype="bf16")),
        ]
    from ..ops.seqbeam import NARROW_DIM

    if config.dim > NARROW_DIM:
        return []
    return [
        ("seqbeam_int8e_d512!", 3,
         dict(M=8, R=4, pool_mask="altparity", block_b=512,
              interleave=2, reorder="select", e_dtype="int8", zip_skew=1)),
        ("seqbeam_hl_d512", 3,
         dict(M=8, R=4, pool_mask="altparity", block_b=256,
              interleave=2, reorder="select", e_dtype="bf16")),
        ("seqbeam_m16_d512", 2,
         dict(M=16, R=4, block_b=256, interleave=2,
              reorder="select", e_dtype="bf16")),
    ]


def auto_choice(config: QuantizerConfig, x: torch.Tensor, refine_indexes_iters: int):
    """(name, passes, kwargs) of the kernel config that ``"auto"`` runs on
    the (B, dim) frames ``x``, or None for the exact beam; a name that
    starts with ``gramv3_`` is the Gram-table kernel's, any other seqbeam's.

    The kernel is picked only for a CUDA tensor, a supported config and at
    least 3 refinement iterations, and only a candidate with a passing smoke
    entry in the port's ``ops/verified.json`` whose combined margin (train
    ratio x worst-seed encode delta, ``ops/quality.json``) is within the 1%
    bar; the Gram-table rung only for at least :data:`GRAMV3_MIN_FRAMES`
    frames.  Off the GPU auto is the beam, as the JAX package's auto is off
    the TPU."""
    from ..ops.seqbeam import SEQBEAM_SUPPORTED
    from ..ops.verify import combined_margin_pct, kernel_verified

    if not (SEQBEAM_SUPPORTED(config) and x.is_cuda and refine_indexes_iters >= 3):
        return None
    few = x.shape[0] < GRAMV3_MIN_FRAMES.get((config.dim, config.num_codebooks), 0)
    for name, iters, tuned in _auto_candidates(config):
        if few and name.startswith("gramv3_"):
            continue
        need_quality = name.endswith("!")
        name = name.rstrip("!")
        margin = combined_margin_pct(name)
        if margin is None and need_quality:
            continue
        if kernel_verified(name) and (margin is None or margin <= 1.0):
            return name, iters, tuned
    return None


def encode(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    refine_indexes_iters: int = 5,
    as_bytes: bool = True,
    search_method: str = "beam",
    **search_kwargs,
) -> torch.Tensor:
    """Quantize ``x``: (*, dim) -> (*, nc) int32 indexes, or
    (*, bytes_per_frame) uint8 when ``as_bytes``
    (`quantization/quantization.py:244-275`).

    ``search_method``:
      * "beam": the reference's pair-tree beam search;
      * "seqbeam": the sequential-beam kernel (ops/seqbeam.py);
        ``refine_indexes_iters`` counts beam sweeps;
      * "cdN+seqbeam" (e.g. "cd2+seqbeam"): N coordinate-descent sweeps as a
        warm start, then the kernel;
      * "cd": exact coordinate descent alone;
      * "gramv3": the Gram-table kernel (ops/gramv3.py), any dim,
        codebook_size 256, at most 8 codebooks; ``refine_indexes_iters``
        counts beam sweeps and ``g_dtype="int8"`` selects the int8 table;
      * "auto": the fastest measured config within the quality bar on the
        GPU (see :func:`auto_choice`: the gramv3 or the seqbeam kernel),
        else "beam".
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, config.dim).float()
    if search_method == "auto":
        with span("codec.choose") as sp:
            chosen = auto_choice(config, x2, refine_indexes_iters)
            rung = "beam" if chosen is None else chosen[0]
            sp.set(rung=rung)
        with _AUTO_RUNGS_LOCK:
            AUTO_RUNGS[rung] += 1
        if chosen is not None:
            name, refine_indexes_iters, tuned = chosen
            search_method = "gramv3" if name.startswith("gramv3_") else "seqbeam"
            search_kwargs = {**tuned, **search_kwargs}
        elif search_kwargs:
            raise ValueError(
                f"search kwargs {sorted(search_kwargs)} require a search kernel "
                "(CUDA tensor, codebook_size=256, dim a multiple of 128); pass "
                "search_method='seqbeam' or 'gramv3' explicitly or drop the kwargs"
            )
        else:
            search_method = "beam"
    with span("codec.search"):
        indexes = _search_indexes(params, config, x2, refine_indexes_iters, search_method,
                                  search_kwargs)
    if as_bytes:
        with span("codec.pack"):
            indexes = pack_indexes(indexes, config.codebook_size)
    return indexes.reshape(*lead, -1)


def _search_indexes(params: QuantizerParams, config: QuantizerConfig, x2: torch.Tensor,
                    refine_indexes_iters: int, search_method: str,
                    search_kwargs: dict) -> torch.Tensor:
    """(B, nc) int32 indexes of (B, dim) f32 frames by ``search_method``
    (any of :func:`encode`'s but "auto")."""
    if search_method == "gramv3":
        from ..ops.gramv3 import gramv3_encode_indexes

        return gramv3_encode_indexes(
            params, config, x2, passes=refine_indexes_iters, **search_kwargs)
    warm = re.fullmatch(r"cd(\d+)\+seqbeam", search_method)
    if search_method == "seqbeam" or warm:
        from ..ops.seqbeam import seqbeam_encode_indexes

        init = None
        if warm:
            logits = search.compute_logits(params, config, x2)
            init = search.refine_indexes_cd(
                scaled_centers(params, config.scale_speed),
                x2,
                torch.argmax(logits, dim=-1).to(torch.int32),
                sweeps=int(warm.group(1)),
            )
        return seqbeam_encode_indexes(
            params, config, x2, passes=refine_indexes_iters, init_indexes=init,
            **search_kwargs,
        )
    if search_kwargs:
        raise ValueError(f"search kwargs {sorted(search_kwargs)} need the seqbeam kernel")
    return search.compute_indexes(
        params, config, x2, refine_indexes_iters, search=search_method
    )


def decode_indexes(centers: torch.Tensor, indexes: torch.Tensor) -> torch.Tensor:
    """Gather-and-sum reconstruction from unpacked (B, nc) indexes
    (`quantization/quantization.py:136-148`)."""
    nc = centers.shape[0]
    ncs = torch.arange(nc, device=centers.device)
    return centers[ncs[None, :], indexes.long()].sum(dim=1)


def decode_onehot(centers: torch.Tensor, indexes: torch.Tensor) -> torch.Tensor:
    """One-hot-matmul reconstruction; numerically equal to
    :func:`decode_indexes` up to summation order, and differentiable into a
    matmul with respect to ``centers``."""
    nc, cs, _ = centers.shape
    onehot = torch.nn.functional.one_hot(indexes.long(), cs).to(centers.dtype)
    return torch.einsum("bnk,nkd->bd", onehot, centers)


def decode(
    params: QuantizerParams,
    config: QuantizerConfig,
    indexes: torch.Tensor,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Reconstruct (*, dim) from (possibly byte-packed) indexes
    (`quantization/quantization.py:117-148`).  ``use_kernel=True`` uses the
    fused decode (ops/decode.py), which applies the codebooks in bf16."""
    if use_kernel:
        from ..ops.decode import decode_kernel

        return decode_kernel(params, config, indexes)
    lead = indexes.shape[:-1]
    idx = indexes.reshape(-1, indexes.shape[-1])
    idx = unpack_indexes(idx, config.codebook_size, config.num_codebooks)
    centers = scaled_centers(params, config.scale_speed)
    return decode_indexes(centers, idx).reshape(*lead, config.dim)
