"""Diagnostics: codebook subspace-correlation matrix.

PyTorch counterpart of ``quantization_tpu/core/diagnostics.py``
(`quantization/quantization.py:150-181`): for mean-centred codebooks with
uncentred variances S_i, c_ij = tr(S_i S_j) / sqrt(c_ii c_jj), a symmetric
(nc, nc) matrix in [0, 1] measuring how strongly pairs of codebooks share a
subspace.
"""

from __future__ import annotations

import torch

from .types import QuantizerConfig, QuantizerParams, scaled_centers


@torch.no_grad()
def codebook_correlations(params: QuantizerParams, config: QuantizerConfig) -> torch.Tensor:
    centers = scaled_centers(params, config.scale_speed).detach()
    centers = centers - centers.mean(dim=1, keepdim=True)
    # variances (nc, dim, dim); tr(S_i S_j) = <S_i, S_j>_F for symmetric S
    variances = torch.einsum("nkd,nke->nde", centers, centers)
    flat = variances.reshape(config.num_codebooks, -1)
    cross = flat @ flat.t()
    norm = torch.rsqrt(torch.diagonal(cross))
    return cross * norm[None, :] * norm[:, None]
