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
