"""Encode / decode and uint8 byte packing.

PyTorch counterpart of ``quantization_tpu/core/codec.py``
(`quantization/quantization.py:117-148, 244-275, 551-573`).
"""

from __future__ import annotations

import re

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


def auto_choice(config: QuantizerConfig, x: torch.Tensor, refine_indexes_iters: int):
    """(name, passes, kwargs) of the rung that ``"auto"`` runs on the (B,
    dim) frames ``x`` (:func:`ops.ladder.pick`), or None for the exact beam."""
    from ..ops import ladder

    rung = ladder.pick(config, x, refine_indexes_iters)
    return None if rung is None else (rung.name, rung.passes, rung.kwargs())


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
        GPU (see :func:`ops.ladder.pick`: a gramv3 or a seqbeam rung), else
        "beam"; ``search_kwargs`` override the rung's.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, config.dim)
    rung = None
    if search_method == "auto":
        from ..ops import ladder

        with span("codec.choose") as sp:
            rung = ladder.pick(config, x2, refine_indexes_iters)
            sp.set(rung="beam" if rung is None else rung.name)
        if rung is None and search_kwargs:
            raise ValueError(
                f"search kwargs {sorted(search_kwargs)} require a search kernel "
                "(CUDA tensor, codebook_size=256, dim a multiple of 128); pass "
                "search_method='seqbeam' or 'gramv3' explicitly or drop the kwargs"
            )
        search_method = "beam"
    with span("codec.search"):
        if rung is not None:
            indexes = rung.kernel.encode(params, config, x2, passes=rung.passes,
                                         **{**rung.kwargs(), **search_kwargs})
        else:
            indexes = _search_indexes(params, config, x2, refine_indexes_iters, search_method,
                                      search_kwargs)
    if as_bytes:
        with span("codec.pack"):
            indexes = pack_indexes(indexes, config.codebook_size)
    return indexes.reshape(*lead, -1)


def _search_indexes(params: QuantizerParams, config: QuantizerConfig, x2: torch.Tensor,
                    refine_indexes_iters: int, search_method: str,
                    search_kwargs: dict) -> torch.Tensor:
    """(B, nc) int32 indexes of (B, dim) frames by ``search_method`` (any
    of :func:`encode`'s but "auto"), cast to f32 here or by a kernel's problem."""
    if search_method == "gramv3":
        from ..ops.gramv3 import gramv3_encode_indexes

        return gramv3_encode_indexes(
            params, config, x2, passes=refine_indexes_iters, **search_kwargs)
    warm = re.fullmatch(r"cd(\d+)\+seqbeam", search_method)
    if search_method == "seqbeam" or warm:
        from ..ops.seqbeam import seqbeam_encode_indexes

        init = None
        if warm:
            x2 = x2.float()
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
        params, config, x2.float(), refine_indexes_iters, search=search_method
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
