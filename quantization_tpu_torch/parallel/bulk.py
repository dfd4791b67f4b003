"""Mesh-wide bulk encode and decode.

PyTorch counterpart of ``quantization_tpu/parallel/bulk.py``.  Bulk corpus
encoding is embarrassingly parallel over frames: codebooks are replicated,
each rank of the mesh's 'data' axis encodes its block of the frames, and the
codes are all-gathered over the data group in rank order.  Each rank calls
with the whole batch and gets the whole result, as the JAX call returns one
global array.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.types import QuantizerConfig, QuantizerParams
from .mesh import Mesh


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows of ``t``, after padding them with zero
    rows to a multiple of the data axis, on the mesh's device."""
    ndata = mesh.shape["data"]
    local = -(-t.shape[0] // ndata)
    block = t[mesh.coords["data"] * local:][:local].to(mesh.device)
    if block.shape[0] < local:
        pad = block.new_zeros((local - block.shape[0], *t.shape[1:]))
        block = torch.cat([block, pad])
    return block


def encode_sharded(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    mesh: Mesh,
    refine_indexes_iters: int = 5,
    search_method: str = "auto",
    **search_kwargs,
) -> torch.Tensor:
    """Encode (B, dim) frames with B split over the mesh's 'data' axis.

    Each rank encodes only its ``B_pad / num_data`` rows (B padded with zero
    rows to a multiple of the data axis; the pad frames are encoded and
    dropped) through ``core.codec.encode``, so on the GPU the kernel
    searches ("auto", "seqbeam", "gramv3") run on the local rows, with the
    kernel's own padding per shard.  On a mesh with a 'model' axis the
    parameters and frames are replicated across the model group (the
    encode is not dim-split), and the search must be "auto", "beam" or
    "cd", as in the JAX package.  Returns the (B, bytes_per_frame) uint8
    codes on every rank."""
    if mesh.shape["model"] > 1 and search_method not in ("auto", "beam", "cd"):
        raise ValueError(
            f"search_method={search_method!r} requires a kernel, which needs replicated "
            "codebooks; use a data-only mesh")
    params = _on(params, mesh)
    codes = codec.encode(params, config, _rows(x, mesh),
                         refine_indexes_iters=refine_indexes_iters,
                         search_method=search_method, **search_kwargs)
    return mesh.all_gather(codes, "data")[:x.shape[0]]


def decode_sharded(
    params: QuantizerParams,
    config: QuantizerConfig,
    codes: torch.Tensor,
    mesh: Mesh,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Decode byte codes with the batch split over the 'data' axis; each rank
    decodes its rows through ``core.codec.decode`` (``use_kernel=True``: the
    decode kernel on the GPU) and gets the whole (B, dim) result."""
    params = _on(params, mesh)
    recon = codec.decode(params, config, _rows(codes, mesh), use_kernel=use_kernel)
    return mesh.all_gather(recon, "data")[:codes.shape[0]]


def _on(params: QuantizerParams, mesh: Mesh) -> QuantizerParams:
    """Whole ``params`` on the mesh's device: replicated on every rank."""
    return QuantizerParams(**{k: v.to(mesh.device) for k, v in vars(params).items()})
