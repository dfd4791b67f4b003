"""Parameter initialization.

Reproduces the distributional init of the reference
(`quantization/quantization.py:38-46`): ``to_logits`` weight and bias are
drawn from U(-1/sqrt(dim), +1/sqrt(dim)) like a torch ``nn.Linear``;
``centers`` starts as a copy of the reshaped predictor weight; the two
log-scales start at zero.
"""

from __future__ import annotations

import binascii
import math
import os

import torch

from .types import QuantizerConfig, QuantizerParams


def init_quantizer_params(
    generator: torch.Generator,
    config: QuantizerConfig,
    device=None,
    dtype=torch.float32,
) -> QuantizerParams:
    """Fresh parameters drawn from ``generator`` (a CPU ``torch.Generator``;
    the draws are moved to ``device`` afterwards, so a seed gives the same
    parameters on every device)."""
    nc, cs, dim = config.num_codebooks, config.codebook_size, config.dim
    bound = 1.0 / math.sqrt(dim)

    def uniform(*shape):
        u = torch.rand(*shape, generator=generator, dtype=dtype)
        return (u * (2 * bound) - bound).to(device)

    w = uniform(nc * cs, dim)
    b = uniform(nc * cs)
    return QuantizerParams(
        centers=w.reshape(nc, cs, dim).clone(),
        to_logits_w=w,
        to_logits_b=b,
        logits_scale=torch.zeros((), dtype=dtype, device=device),
        centers_scale=torch.zeros((), dtype=dtype, device=device),
    )


def random_id() -> str:
    """8-hex-char quantizer identity (`quantization/quantization.py:49-55`)."""
    return binascii.b2a_hex(os.urandom(4)).decode("utf-8")


def init_quantizer_params_from_centers(
    generator: torch.Generator,
    config: QuantizerConfig,
    centers: torch.Tensor,
    device=None,
    dtype=torch.float32,
) -> QuantizerParams:
    """Parameters from externally fitted codebooks (a short multi-kmeans
    run: the trainer's ``init="multi_kmeans"``).

    The reference starts ``centers`` as a clone of ``to_logits.weight``
    (`quantization/quantization.py:38-42`); here it is the other way round:
    the ``to_logits`` rows start as a copy of the supplied centers, in their
    own storage, so that an optimiser never updates one tensor as two
    parameters.  The bias is drawn from ``generator`` as
    :func:`init_quantizer_params` draws its bias (after the weight's draw,
    discarded here); the two log-scales start at zero."""
    nc, cs, dim = config.num_codebooks, config.codebook_size, config.dim
    if tuple(centers.shape) != (nc, cs, dim):
        raise ValueError(f"centers {tuple(centers.shape)} do not match {(nc, cs, dim)}")
    bound = 1.0 / math.sqrt(dim)
    torch.rand(nc * cs, dim, generator=generator, dtype=dtype)  # the weight's draw
    b = torch.rand(nc * cs, generator=generator, dtype=dtype) * (2 * bound) - bound
    centers = centers.detach().to(device=device, dtype=dtype).clone()
    return QuantizerParams(
        centers=centers,
        to_logits_w=centers.reshape(nc * cs, dim).clone(),
        to_logits_b=b.to(device),
        logits_scale=torch.zeros((), dtype=dtype, device=device),
        centers_scale=torch.zeros((), dtype=dtype, device=device),
    )
