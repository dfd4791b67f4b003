"""Joint codebook-index predictor.

PyTorch counterpart of ``quantization_tpu/models/prediction.py`` (the
reference's `quantization/prediction.py`): predict the num_codebooks
codebook indexes of a frame from an external feature vector, *jointly*:
codebook k is regressed on the predictor features plus embeddings of
codebooks 0..k-1.

  1. offset the first nc-1 indexes into a shared (nc-1)*cs embedding table,
  2. scale embeddings by 0.5 * sqrt(hidden/nc), prepend linear1(predictor),
  3. cumulative-sum over the codebook axis (so position k sees all previous
     codebooks), ReLU,
  4. logits = per-codebook linear2(hidden) + per-codebook linear2b(predictor)
     + bias,
  5. cross-entropy against the indexes, with ignore_index padding masked out.

The products are f32 ``torch.einsum`` (TF32 off, ``core/precision.py``);
memory saving uses :func:`~quantization_tpu_torch.utils.checkpoint.checkpoint`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import torch
from torch import nn

from ..core.types import resolve_device
from ..utils.checkpoint import checkpoint as _checkpoint


@dataclasses.dataclass
class JointCodebookParams:
    """The predictor's parameters; shapes as documented at
    `quantization/prediction.py:19-33`."""

    linear1_w: torch.Tensor  # (hidden, predictor_channels)
    linear1_b: torch.Tensor  # (hidden,)
    embedding: torch.Tensor  # ((nc - 1) * cs, hidden)
    linear2_w: torch.Tensor  # (nc, cs, hidden)
    linear2b_w: torch.Tensor  # (nc, cs, predictor_channels)
    linear2_b: torch.Tensor  # (nc, cs)


JOINT_CODEBOOK_FIELDS = tuple(f.name for f in dataclasses.fields(JointCodebookParams))


def init_joint_codebook_params(
    generator: torch.Generator,
    predictor_channels: int,
    num_codebooks: int,
    hidden_channels: int = 512,
    codebook_size: int = 256,
    device=None,
) -> JointCodebookParams:
    """The init distributions of `quantization/prediction.py:138-153`:
    linear1 as a default torch Linear (U(+-1/sqrt(fan_in))); the embedding
    and the two output weights randn scaled by fan_in**-0.5; bias zero.
    Drawn from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device`` (default CPU), so a seed gives the same parameters on every
    device."""
    P, nc, cs, H = predictor_channels, num_codebooks, codebook_size, hidden_channels
    bound = 1.0 / math.sqrt(P)

    def uniform(*shape):
        return torch.rand(*shape, generator=generator) * (2 * bound) - bound

    def normal(*shape):
        return torch.randn(*shape, generator=generator)

    params = JointCodebookParams(
        linear1_w=uniform(H, P),
        linear1_b=uniform(H),
        embedding=normal((nc - 1) * cs, H) * H ** -0.5,
        linear2_w=normal(nc, cs, H) * H ** -0.5,
        linear2b_w=normal(nc, cs, P) * P ** -0.5,
        linear2_b=torch.zeros(nc, cs),
    )
    return JointCodebookParams(**{f: getattr(params, f).to(device) for f in JOINT_CODEBOOK_FIELDS})


def joint_codebook_logits(
    params: JointCodebookParams,
    predictor: torch.Tensor,
    codebook_indexes: torch.Tensor,
) -> torch.Tensor:
    """(N, predictor_channels), (N, nc) -> (N, nc, cs) prediction logits."""
    nc, cs, hidden = params.linear2_w.shape
    idx = codebook_indexes.long()
    # All but the last codebook feeds the prediction of later ones; padding
    # (-100) is clamped to 0, and those frames are masked in the loss
    # (`quantization/prediction.py:44-50`).
    offsets = torch.arange(0, (nc - 1) * cs, cs, device=idx.device)
    first = idx[:, :-1].clamp(min=0) + offsets
    first_emb = params.embedding[first] * (0.5 * math.sqrt(hidden / nc))  # (N, nc-1, hidden)

    hidden_pred = predictor @ params.linear1_w.T + params.linear1_b
    all_emb = torch.cat([hidden_pred[:, None, :], first_emb], dim=1)
    # after the cumsum every position holds the predictor's contribution
    # plus all *previous* codebooks (`quantization/prediction.py:58-65`)
    all_emb = torch.relu(torch.cumsum(all_emb, dim=1))

    logits = torch.einsum("bnh,nkh->bnk", all_emb, params.linear2_w)
    logits = logits + torch.einsum("bp,nkp->bnk", predictor, params.linear2b_w)
    return logits + params.linear2_b


def joint_codebook_loss(
    params: JointCodebookParams,
    predictor: torch.Tensor,
    codebook_indexes: torch.Tensor,
    ignore_index: int = -100,
    reduction: str = "sum",
) -> torch.Tensor:
    """Cross-entropy of the joint prediction; padding frames (index ==
    ignore_index) contribute zero (`quantization/prediction.py:79-82`).
    ``reduction``: "sum", "mean" (over the unmasked entries) or "none"
    (the (N, nc) losses)."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    lead = predictor.shape[:-1]
    if codebook_indexes.shape[:-1] != lead:
        raise ValueError(f"predictor {tuple(predictor.shape)} and codebook_indexes "
                         f"{tuple(codebook_indexes.shape)} differ in their leading shape")
    predictor = predictor.reshape(-1, predictor.shape[-1])
    idx = codebook_indexes.reshape(-1, codebook_indexes.shape[-1]).long()

    logits = joint_codebook_logits(params, predictor, idx)
    logprobs = torch.log_softmax(logits, dim=-1)
    chosen = logprobs.gather(-1, idx.clamp(min=0)[..., None])[..., 0]
    mask = (idx != ignore_index).to(chosen.dtype)
    losses = -chosen * mask
    if reduction == "sum":
        return losses.sum()
    if reduction == "mean":
        return losses.sum() / mask.sum().clamp(min=1.0)
    return losses


class JointCodebookLoss(nn.Module):
    """The module of `quantization/prediction.py:86-189`.

    Holds the parameters under the :class:`JointCodebookParams` field names;
    ``module(predictor, codebook_indexes)`` returns the cross-entropy (summed
    by default).  With ``checkpoint=True`` the loss runs under
    :func:`~quantization_tpu_torch.utils.checkpoint.checkpoint` (its
    activations recomputed in backward).  Built on the GPU unless ``device``
    says otherwise; ``params`` gives initial values (copied), else they are
    drawn from ``generator``.
    """

    def __init__(
        self,
        predictor_channels: int,
        num_codebooks: int,
        hidden_channels: int = 512,
        codebook_size: int = 256,
        reduction: str = "sum",
        ignore_index: int = -100,
        checkpoint: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        params: Optional[JointCodebookParams] = None,
        device=None,
    ):
        super().__init__()
        if num_codebooks < 2:
            raise ValueError(f"num_codebooks must be at least 2, got {num_codebooks}")
        device = resolve_device(device)
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.hidden_channels = hidden_channels
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.checkpoint = checkpoint
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(int.from_bytes(os.urandom(4), "little"))
            params = init_joint_codebook_params(generator, predictor_channels, num_codebooks,
                                                hidden_channels, codebook_size)
        for f in JOINT_CODEBOOK_FIELDS:
            setattr(self, f, nn.Parameter(getattr(params, f).detach().clone().to(device)))

    @property
    def params(self) -> JointCodebookParams:
        """The parameters as the functional core takes them (no copies)."""
        return JointCodebookParams(**{f: getattr(self, f) for f in JOINT_CODEBOOK_FIELDS})

    def loss_fn(self, params: JointCodebookParams, predictor: torch.Tensor,
                codebook_indexes: torch.Tensor) -> torch.Tensor:
        fn = functools.partial(joint_codebook_loss, ignore_index=self.ignore_index,
                               reduction=self.reduction)
        if self.checkpoint:
            return _checkpoint(fn, params, predictor, codebook_indexes)
        return fn(params, predictor, codebook_indexes)

    def forward(self, predictor: torch.Tensor, codebook_indexes: torch.Tensor) -> torch.Tensor:
        return self.loss_fn(self.params, predictor, codebook_indexes)
