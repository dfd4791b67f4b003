"""Synthetic data generators.

``make_mlp_sampler`` reproduces the reference's "typical neural-net output"
distribution (`quantization/test_quantization.py:16-32`): a 3-layer random
MLP with ReLUs and a LayerNorm, plus a 0.05 x residual.  The trained
quantizers in ``experiments/`` were trained on the JAX package's sampler
built from ``PRNGKey(42)``; its three layers' weights ship beside this
module as ``mlp_sampler_d{dim}_key42.npz`` (float32 ``w1, b1, w2, b2, w3,
b3``; the test suite checks them against the JAX construction), so the port
draws from the same distribution without JAX.  No JAX key exists for dim
1280 (the d1280 / 8 B quantizer is the port's own): its MLP's weights,
:func:`seeded_mlp_weights` of seed 42, ship as
``mlp_sampler_d1280_seed42.npz`` (float16).  ``make_double_sampler``
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
MLP_DIMS = (256, 512, 1280)
KEY42_DIMS = (256, 512)  # the JAX package's key-42 samplers (and double samplers)
SEEDED_MLP_SEED = 42  # the seed of d1280's weights


def mlp_weights_path(dim: int) -> pathlib.Path:
    if dim in KEY42_DIMS:
        return _HERE / f"mlp_sampler_d{dim}_key42.npz"
    return _HERE / f"mlp_sampler_d{dim}_seed{SEEDED_MLP_SEED}.npz"


def seeded_mlp_weights(dim: int, seed: int) -> dict:
    """The three layers of a dim-wide sampler MLP drawn from a CPU
    ``torch.Generator`` seeded ``seed``, as float16 arrays ``w1, b1, w2, b2,
    w3, b3`` (weights (out, in)).  Each weight is a random sign times
    ``1 / sqrt(3 dim)``, the standard deviation of the reference's
    ``nn.Linear`` initialisation (uniform within ``1 / sqrt(dim)``), which
    keeps the compressed file near 1 MB at dim 1280; the biases are that
    uniform draw."""
    g = torch.Generator().manual_seed(seed)
    a = 1.0 / np.sqrt(3.0 * dim)
    out = {}
    for i in (1, 2, 3):
        signs = torch.randint(0, 2, (dim, dim), generator=g).numpy() * 2 - 1
        out[f"w{i}"] = (signs * a).astype(np.float16)
        bias = (torch.rand(dim, generator=g, dtype=torch.float64) * 2 - 1) / np.sqrt(dim)
        out[f"b{i}"] = bias.numpy().astype(np.float16)
    return out


def double_weights_paths(dim: int) -> List[pathlib.Path]:
    """The weights of the two dim/2 halves of ``make_double_sampler(dim)``."""
    return [_HERE / f"double_sampler_d{dim}_key42_{i}.npz" for i in (0, 1)]


def _mlp(path: pathlib.Path, dim: int, device: torch.device):
    """``sample(generator, batch)`` of the 3-layer MLP whose weights are in
    ``path``."""
    with np.load(path) as z:
        w = {k: torch.from_numpy(np.array(z[k], np.float32)).to(device) for k in z.files}

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
    ``device`` (default: the GPU) from the shipped MLP of ``dim`` (the
    key-42 one, at 1280 the seeded one)."""
    if dim not in MLP_DIMS:
        raise ValueError(f"no shipped MLP sampler weights for dim={dim} (have {MLP_DIMS})")
    return _mlp(mlp_weights_path(dim), dim, resolve_device(device))


def make_double_sampler(
    dim: int, device=None
) -> Callable[[torch.Generator, int], torch.Tensor]:
    """Returns ``sample(generator, batch) -> (batch, dim)`` float32 frames on
    ``device`` (default: the GPU): two independent dim/2 draws from two MLP
    samplers, concatenated (`quantization/test_quantization.py:87-110`)."""
    if dim not in KEY42_DIMS:
        raise ValueError(f"no shipped double sampler weights for dim={dim} (have {KEY42_DIMS})")
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
