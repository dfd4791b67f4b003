"""Product-quantizer growth: (nc, cs) -> (nc/2, cs^2).

PyTorch counterpart of ``quantization_tpu/core/growth.py``; the reference
builds the product quantizer with a triple-nested loop
(`quantization/quantization.py:96-111`).  Here it is one broadcast outer
sum:

    new_centers[c, k1*cs + k2] = centers[2c, k1] + centers[2c+1, k2]

and the same for the ``to_logits`` rows and biases.  The two learned scales
are copied.
"""

from __future__ import annotations

import torch

from .types import QuantizerConfig, QuantizerParams


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """(nc, cs, ...) -> (nc//2, cs*cs, ...) with out[c, k1*cs+k2] =
    a[2c, k1] + a[2c+1, k2]."""
    nc, cs = a.shape[0], a.shape[1]
    even = a[0::2].unsqueeze(2)  # (nc/2, cs, 1, ...)
    odd = a[1::2].unsqueeze(1)  # (nc/2, 1, cs, ...)
    return (even + odd).reshape(nc // 2, cs * cs, *a.shape[2:])


def product_params(params: QuantizerParams, config: QuantizerConfig) -> QuantizerParams:
    """Parameters of the product quantizer of ``config.product_config()``,
    as new tensors (detached from ``params``)."""
    nc, cs = config.num_codebooks, config.codebook_size
    # elementwise over dim, so a device of a model axis forms its own slice
    dim = params.to_logits_w.shape[-1]
    with torch.no_grad():
        w3 = params.to_logits_w.reshape(nc, cs, dim)
        b2 = params.to_logits_b.reshape(nc, cs)
        new_nc, new_cs = nc // 2, cs * cs
        return QuantizerParams(
            centers=_pairwise_sum(params.centers),
            to_logits_w=_pairwise_sum(w3).reshape(new_nc * new_cs, dim),
            to_logits_b=_pairwise_sum(b2).reshape(new_nc * new_cs),
            logits_scale=params.logits_scale.clone(),
            centers_scale=params.centers_scale.clone(),
        )
