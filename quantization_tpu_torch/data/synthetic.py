"""Synthetic data generators.

``make_mlp_sampler`` reproduces the reference's "typical neural-net output"
distribution (`quantization/test_quantization.py:16-32`): a 3-layer random
MLP with ReLUs and a LayerNorm, plus a 0.05 x residual.  The trained
quantizers in ``experiments/`` were trained on the JAX package's sampler
built from ``PRNGKey(42)``; its three layers' weights ship beside this
module as ``mlp_sampler_d{dim}_key42.npz`` (float32 ``w1, b1, w2, b2, w3,
b3``; the test suite checks them against the JAX construction), so the port
draws from the same distribution without JAX.  ``make_double_sampler``
concatenates two dim/2 MLP samplers, built there from the two keys of
``jax.random.split(PRNGKey(42))``; their weights ship as
``double_sampler_d{dim}_key42_{0,1}.npz``.  The input noise comes from a
CPU ``torch.Generator``, so a seed gives the same frames on every device.
"""

from __future__ import annotations

import pathlib
from typing import Callable, List

import numpy as np
import torch

from ..core.types import resolve_device

_HERE = pathlib.Path(__file__).resolve().parent
MLP_DIMS = (256, 512)


def mlp_weights_path(dim: int) -> pathlib.Path:
    return _HERE / f"mlp_sampler_d{dim}_key42.npz"


def double_weights_paths(dim: int) -> List[pathlib.Path]:
    """The weights of the two dim/2 halves of ``make_double_sampler(dim)``."""
    return [_HERE / f"double_sampler_d{dim}_key42_{i}.npz" for i in (0, 1)]


def _mlp(path: pathlib.Path, dim: int, device: torch.device):
    """``sample(generator, batch)`` of the 3-layer MLP whose weights are in
    ``path``."""
    with np.load(path) as z:
        w = {k: torch.from_numpy(z[k]).to(device) for k in z.files}

    def sample(generator: torch.Generator, batch: int) -> torch.Tensor:
        x = torch.randn(batch, dim, generator=generator).to(device)
        h = torch.relu(x @ w["w1"].t() + w["b1"])
        h = torch.relu(h @ w["w2"].t() + w["b2"])
        mu = h.mean(dim=-1, keepdim=True)
        var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + 1e-5)
        h = h @ w["w3"].t() + w["b3"]
        return h + 0.05 * x

    return sample


def make_mlp_sampler(
    dim: int, device=None
) -> Callable[[torch.Generator, int], torch.Tensor]:
    """Returns ``sample(generator, batch) -> (batch, dim)`` float32 frames on
    ``device`` (default: the GPU) from the shipped key-42 MLP."""
    if dim not in MLP_DIMS:
        raise ValueError(f"no shipped MLP sampler weights for dim={dim} (have {MLP_DIMS})")
    return _mlp(mlp_weights_path(dim), dim, resolve_device(device))


def make_double_sampler(
    dim: int, device=None
) -> Callable[[torch.Generator, int], torch.Tensor]:
    """Returns ``sample(generator, batch) -> (batch, dim)`` float32 frames on
    ``device`` (default: the GPU): two independent dim/2 draws from two MLP
    samplers, concatenated (`quantization/test_quantization.py:87-110`)."""
    if dim not in MLP_DIMS:
        raise ValueError(f"no shipped double sampler weights for dim={dim} (have {MLP_DIMS})")
    device = resolve_device(device)
    halves = [_mlp(path, dim // 2, device) for path in double_weights_paths(dim)]

    def sample(generator: torch.Generator, batch: int) -> torch.Tensor:
        return torch.cat([half(generator, batch) for half in halves], dim=-1)

    return sample


def gaussian_sampler(dim: int, device=None) -> Callable[[torch.Generator, int], torch.Tensor]:
    """``sample(generator, batch)``: unit Gaussian frames on ``device``
    (default: the GPU) (the reference's rate-distortion suite,
    `quantization/test_quantization.py:51-84`)."""
    device = resolve_device(device)

    def sample(generator: torch.Generator, batch: int) -> torch.Tensor:
        return torch.randn(batch, dim, generator=generator).to(device)

    return sample


def shannon_distortion(dim: int, bytes_per_frame: int) -> float:
    """Rate-distortion bound for unit Gaussian data: D = 2**(-2R) with
    R = 8 * bytes_per_frame / dim bits per dimension
    (`quantization/test_quantization.py:56-61`)."""
    rate = 8.0 * bytes_per_frame / dim
    return 2.0 ** (-2.0 * rate)
