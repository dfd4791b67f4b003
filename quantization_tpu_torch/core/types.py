"""Core types of the PyTorch multi-codebook quantizer.

A frozen, hashable :class:`QuantizerConfig` holds the static shape of a
quantizer; :class:`QuantizerParams` holds its five parameter tensors.  The
functions of ``core`` take both and work on whatever device the tensors are
on.  :class:`~quantization_tpu_torch.models.quantizer.Quantizer` is the
``nn.Module`` that owns the parameters and hands them to ``core``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """Static configuration of a multi-codebook quantizer.

    ``dim``, ``codebook_size`` and ``num_codebooks`` follow the reference's
    power-of-two constraints (`quantization/quantization.py:20-36`);
    ``scale_speed`` multiplies the two learned log-scales
    (`quantization/quantization.py:46`).
    """

    dim: int
    codebook_size: int
    num_codebooks: int
    scale_speed: float = 10.0

    def __post_init__(self):
        if not _is_power_of_two(self.codebook_size):
            raise ValueError(f"codebook_size {self.codebook_size} is not a power of 2")
        if not _is_power_of_two(self.num_codebooks):
            raise ValueError(f"num_codebooks {self.num_codebooks} is not a power of 2")

    @property
    def bytes_per_frame(self) -> int:
        """Number of uint8 bytes produced per frame by packed encode."""
        cs, n = self.codebook_size, self.num_codebooks
        while cs ** 2 <= 256:
            cs = cs ** 2
            n //= 2
        return n

    def product_config(self) -> "QuantizerConfig":
        """Config after one product-growth step (cs -> cs**2, nc -> nc//2);
        see `quantization/quantization.py:87-88`."""
        return QuantizerConfig(
            dim=self.dim,
            codebook_size=self.codebook_size ** 2,
            num_codebooks=self.num_codebooks // 2,
            scale_speed=self.scale_speed,
        )


@dataclasses.dataclass
class QuantizerParams:
    """The reference parameter set (`quantization/quantization.py:38-46`):

    - ``to_logits_w``: (num_codebooks * codebook_size, dim) predictor weight
    - ``to_logits_b``: (num_codebooks * codebook_size,) predictor bias
    - ``centers``: (num_codebooks, codebook_size, dim)
    - ``logits_scale``, ``centers_scale``: scalar log-scales
    """

    centers: torch.Tensor
    to_logits_w: torch.Tensor
    to_logits_b: torch.Tensor
    logits_scale: torch.Tensor
    centers_scale: torch.Tensor

    def detach(self) -> "QuantizerParams":
        """The same tensors, detached from any autograd graph."""
        return QuantizerParams(**{f.name: getattr(self, f.name).detach()
                                  for f in dataclasses.fields(self)})


class QuantizerLosses(NamedTuple):
    """The four loss terms of ``compute_loss``
    (`quantization/quantization.py:193-209`)."""

    rel_reconstruction_loss: torch.Tensor
    logprob_loss: torch.Tensor
    logits_entropy_loss: torch.Tensor
    index_entropy_loss: torch.Tensor


class Reducer:
    """How the partial results of one device combine into the whole batch's.

    On one device every method is the identity, which is this base class.
    Under a mesh (``parallel.mesh.MeshReducer``) a device holds some rows of
    the batch and, with a model axis, ``1 / dim_parts`` of the dim columns
    of the frames and codebooks:

    * :meth:`dims` sums a contraction over dim across the model axis;
    * :meth:`rows` sums over batch rows across the data axis;
    * :meth:`mean` is the mean over the whole batch of a tensor whose axis 0
      is rows (over every axis with ``dim=None``);
    * :meth:`gather_dims` concatenates the dim slices of the last axis.

    The sums are differentiable with an identity backward, so each device's
    gradient is its own share; the trainer sums the gradients afterwards.
    """

    dim_parts = 1

    def dims(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def mean(self, t: torch.Tensor, dim=None) -> torch.Tensor:
        return t.mean() if dim is None else t.mean(dim=dim)

    def gather_dims(self, t: torch.Tensor) -> torch.Tensor:
        return t


LOCAL = Reducer()


def scaled_centers(params: QuantizerParams, scale_speed: float) -> torch.Tensor:
    """Effective codebook centers ``exp(centers_scale * scale_speed) * centers``
    (`quantization/quantization.py:77-79`)."""
    return torch.exp(params.centers_scale * scale_speed) * params.centers


def data_mean(params: QuantizerParams, scale_speed: float) -> torch.Tensor:
    """Approximate training-data mean: mean of each codebook's centers summed
    over codebooks, detached (`quantization/quantization.py:67-75`)."""
    return scaled_centers(params, scale_speed).mean(dim=1).sum(dim=0).detach()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the GPU.

    There is no silent CPU fallback: without CUDA the caller must ask for
    ``device="cpu"`` explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
