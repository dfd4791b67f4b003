"""Multi-codebook k-means-style quantizer (Gibbs-refinement prototype).

PyTorch counterpart of ``quantization_tpu/models/multi_kmeans.py`` (the
reference's experimental `multi_kmeans.py`): no logits predictor; indexes
come from iterative per-codebook refinement.  Training uses *stochastic*
refinement (`multi_kmeans.py:238-326`): sample each codebook's index from a
softmax over negative squared errors with a learned temperature
(``frame_entropy_scale``), giving a differentiable expected-sum-squared loss
plus entropy diagnostics.  Inference uses exact per-codebook coordinate
descent (`multi_kmeans.py:199-235`).

Sampling draws Gumbel noise from the caller's ``torch.Generator`` on the
tensors' device (no host synchronisation); a seed does not reproduce the
JAX package's draws, only their distribution.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..core import codec
from ..core.types import resolve_device


@dataclasses.dataclass
class MultiKmeansParams:
    centers: torch.Tensor  # (nc, cs, dim)
    frame_entropy_scale: torch.Tensor  # scalar; exp(10 * it) scales the softmax

    def detach(self) -> "MultiKmeansParams":
        return MultiKmeansParams(self.centers.detach(), self.frame_entropy_scale.detach())


class StochasticRefineOut(NamedTuple):
    indexes: torch.Tensor  # (B, nc) int32, sampled
    entropy_loss: torch.Tensor  # log(cs) - class entropy (scalar)
    frame_entropy: torch.Tensor  # average per-frame sampling entropy (scalar)
    reconstruction_loss: torch.Tensor  # expected sumsq / sumsq(x) (scalar)


def init_multi_kmeans_params(
    generator: torch.Generator, dim: int, codebook_size: int, num_codebooks: int, device=None
) -> MultiKmeansParams:
    """centers ~ dim**-0.5 * randn (`multi_kmeans.py:32`), drawn from
    ``generator`` (CPU) and moved to ``device`` (default CPU)."""
    centers = dim ** -0.5 * torch.randn(num_codebooks, codebook_size, dim, generator=generator)
    return MultiKmeansParams(centers=centers.to(device),
                             frame_entropy_scale=torch.zeros((), device=device))


def _modified_sumsq(centers: torch.Tensor, x: torch.Tensor, indexes: torch.Tensor):
    """(B, nc, cs) matrix of ||x_err - c_old[n] + c[n,k]||^2: the total squared
    error if codebook n's choice were changed to k, the others fixed.  Expanded
    to x_rem_sumsq + centers_sumsq + 2 <x_rem, c>, the cross term one batched
    product, so that the (B, nc, cs, dim) error tensor is never formed."""
    nc = centers.shape[0]
    old = centers[torch.arange(nc, device=centers.device)[None, :], indexes.long()]  # (B, nc, dim)
    x_err = old.sum(dim=1) - x  # (B, dim)
    x_rem = x_err[:, None, :] - old  # (B, nc, dim)
    x_rem_sumsq = (x_rem * x_rem).sum(dim=-1)  # (B, nc)
    c_sumsq = (centers * centers).sum(dim=-1)  # (nc, cs)
    cross = torch.einsum("bnd,nkd->bnk", x_rem, centers)
    return x_rem_sumsq[:, :, None] + c_sumsq[None] + 2.0 * cross


def refine_indexes(params: MultiKmeansParams, x: torch.Tensor,
                   indexes: torch.Tensor) -> torch.Tensor:
    """Exact coordinate-descent pass: per codebook, the argmin (its first
    minimum) with the others held (`multi_kmeans.py:199-235`)."""
    sumsq = _modified_sumsq(params.centers, x, indexes)
    return torch.argmin(sumsq, dim=2).to(torch.int32)


def sample_categorical(logprobs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index a row of ``logprobs`` (..., cs), drawn by Gumbel-max from
    ``generator`` (on the tensor's device) as int32.  Uniforms are kept off
    0 before the logs."""
    u = torch.rand(logprobs.shape, generator=generator, device=logprobs.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logprobs + gumbel, dim=-1).to(torch.int32)


def refine_indexes_stochastic(
    params: MultiKmeansParams,
    x: torch.Tensor,
    indexes: torch.Tensor,
    generator: torch.Generator,
) -> StochasticRefineOut:
    """Gibbs-style stochastic refinement with losses
    (`multi_kmeans.py:238-326`).  The temperature's gradient flows only
    through ``frame_entropy`` (the squared errors detached there), and the
    centers' only through the expected-sumsq term (the scale detached there),
    the reference's .detach() placement."""
    nc, cs = params.centers.shape[0], params.centers.shape[1]
    sumsq = _modified_sumsq(params.centers, x, indexes)

    # the sampling distribution and per-frame entropy: the gradient reaches
    # only frame_entropy_scale (`multi_kmeans.py:296-305`)
    scale = torch.exp(10.0 * params.frame_entropy_scale)
    logprobs_det = torch.log_softmax(-sumsq.detach() * scale, dim=-1)
    new_indexes = sample_categorical(logprobs_det.detach(), generator)
    probs_det = torch.exp(logprobs_det)
    frame_entropy = -(logprobs_det * probs_det).sum(dim=-1).mean()

    # the expected sumsq: the gradient reaches only the centers
    # (`multi_kmeans.py:308-317`)
    probs = torch.softmax(-sumsq * scale.detach(), dim=-1)
    expected_sumsq = (probs * sumsq).sum() / nc
    reconstruction_loss = expected_sumsq / (x * x).sum()

    avg_probs = probs.mean(dim=0)  # (nc, cs)
    class_entropy = -(avg_probs * torch.log(avg_probs + 1e-20)).sum(dim=1).mean()
    entropy_loss = math.log(cs) - class_entropy

    return StochasticRefineOut(
        indexes=new_indexes,
        entropy_loss=entropy_loss,
        frame_entropy=frame_entropy,
        reconstruction_loss=reconstruction_loss,
    )


def forward(
    params: MultiKmeansParams,
    x: torch.Tensor,
    generator: torch.Generator,
    num_iters: int = 4,
) -> StochasticRefineOut:
    """Training forward: random index init, then ``num_iters`` stochastic
    refinements; the last one's sampled indexes and losses
    (`multi_kmeans.py:108-143`)."""
    nc, cs, dim = params.centers.shape
    x = x.reshape(-1, dim)
    # the reference's torch.randint(codebook_size - 1, ...) excludes the last
    # entry, on this initial draw only (`multi_kmeans.py:133`)
    indexes = torch.randint(0, max(cs - 1, 1), (x.shape[0], nc), generator=generator,
                            device=x.device, dtype=torch.int32)
    out = None
    for _ in range(num_iters):
        out = refine_indexes_stochastic(params, x, indexes, generator)
        indexes = out.indexes
    return out


def encode(
    params: MultiKmeansParams,
    x: torch.Tensor,
    num_iters: int = 4,
    as_bytes: bool = False,
) -> torch.Tensor:
    """Deterministic encode: zero init, then ``num_iters`` coordinate-descent
    passes (`multi_kmeans.py:146-166`); optionally packed into bytes."""
    nc, cs, dim = params.centers.shape
    lead = x.shape[:-1]
    x = x.reshape(-1, dim)
    indexes = torch.zeros(x.shape[0], nc, dtype=torch.int32, device=x.device)
    for _ in range(num_iters):
        indexes = refine_indexes(params, x, indexes)
    if as_bytes:
        indexes = codec.pack_indexes(indexes, cs)
    return indexes.reshape(*lead, -1)


def decode(params: MultiKmeansParams, indexes: torch.Tensor) -> torch.Tensor:
    """Gather-and-sum reconstruction (`multi_kmeans.py:174-197`); takes the
    byte-packed output of ``encode(..., as_bytes=True)`` too."""
    nc, cs, dim = params.centers.shape
    lead = indexes.shape[:-1]
    idx = codec.unpack_indexes(indexes.reshape(-1, indexes.shape[-1]), cs, nc)
    return codec.decode_indexes(params.centers, idx).reshape(*lead, dim)


def compute_ref_loss(params: MultiKmeansParams, x: torch.Tensor) -> torch.Tensor:
    """Relative reconstruction loss sum((decode(encode(x)) - x)^2) / sum(x^2),
    what the reference's training script measures (`multi_kmeans.py:383`)."""
    x2 = x.reshape(-1, params.centers.shape[-1])
    recon = decode(params, encode(params, x2))
    return ((recon - x2) ** 2).sum() / ((x2 * x2).sum() + 1e-20)


def product_params(params: MultiKmeansParams) -> MultiKmeansParams:
    """(nc, cs) -> (nc/2, cs^2) growth by pairwise center sums
    (`multi_kmeans.py:40-61`), index k = cs * even + odd."""
    nc, cs, dim = params.centers.shape
    even = params.centers[0::2][:, :, None, :]
    odd = params.centers[1::2][:, None, :, :]
    return MultiKmeansParams(
        centers=(even + odd).reshape(nc // 2, cs * cs, dim),
        frame_entropy_scale=params.frame_entropy_scale,
    )


class MultiKmeansQuantizer(nn.Module):
    """The reference class's surface (`multi_kmeans.py:17-326`) as an
    ``nn.Module`` holding ``centers`` and ``frame_entropy_scale``.  Built on
    the GPU unless ``device`` says otherwise; ``params`` gives initial values
    (copied), else they are drawn from ``generator``."""

    def __init__(
        self,
        dim: int,
        codebook_size: int,
        num_codebooks: int,
        *,
        generator: Optional[torch.Generator] = None,
        params: Optional[MultiKmeansParams] = None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.codebook_size = codebook_size
        self.num_codebooks = num_codebooks
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(int.from_bytes(os.urandom(4), "little"))
            params = init_multi_kmeans_params(generator, dim, codebook_size, num_codebooks)
        self.centers = nn.Parameter(params.centers.detach().clone().to(device))
        self.frame_entropy_scale = nn.Parameter(
            params.frame_entropy_scale.detach().clone().reshape(()).to(device))

    @property
    def params(self) -> MultiKmeansParams:
        """The parameters as the functions above take them (no copies)."""
        return MultiKmeansParams(self.centers, self.frame_entropy_scale)

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def forward(self, x, generator: torch.Generator, num_iters: int = 4) -> StochasticRefineOut:
        return forward(self.params, self._put(x), generator, num_iters)

    @torch.no_grad()
    def encode(self, x, num_iters: int = 4, as_bytes: bool = False) -> torch.Tensor:
        return encode(self.params, self._put(x), num_iters, as_bytes)

    @torch.no_grad()
    def decode(self, indexes) -> torch.Tensor:
        return decode(self.params, torch.as_tensor(indexes, device=self.device))

    @torch.no_grad()
    def compute_ref_loss(self, x) -> torch.Tensor:
        return compute_ref_loss(self.params, self._put(x))

    def get_product_quantizer(self) -> "MultiKmeansQuantizer":
        return MultiKmeansQuantizer(
            self.dim, self.codebook_size ** 2, self.num_codebooks // 2,
            params=product_params(self.params.detach()), device=self.device)
