"""Training losses.

PyTorch counterpart of ``quantization_tpu/core/losses.py``: the four terms
of the reference ``compute_loss`` (`quantization/quantization.py:184-242`)
with the same gradient routing (`quantization/quantization.py:684-705`):

* ``rel_reconstruction_loss`` trains ``centers`` and ``centers_scale``; the
  search runs under ``torch.no_grad`` on detached inputs, so the integer
  indexes are outside the differentiation path (the JAX package wraps the
  kernel's inputs in ``stop_gradient`` for the same reason);
* ``logprob_loss`` trains only ``to_logits`` and ``logits_scale`` to predict
  the post-refinement indexes;
* ``logits_entropy_loss`` is differentiable, scaled by 0.01 in the trainer;
* ``index_entropy_loss`` is a detached diagnostic.
"""

from __future__ import annotations

import math

import torch

from . import codec, search
from .types import (
    QuantizerConfig,
    QuantizerLosses,
    QuantizerParams,
    data_mean,
    scaled_centers,
)

SEARCH_METHODS = ("beam", "cd", "seqbeam", "gramv3", "gramv3-int8")


@torch.no_grad()
def _train_indexes(params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor,
                   refine_indexes_iters: int, search_method: str) -> torch.Tensor:
    """The (B, nc) training indexes, found without gradients.  The kernel
    searches take the JAX call's arguments: seqbeam at its defaults (M=16,
    R=8, f32 E, all-pool), gramv3 at M=8, R=4, both with
    ``max(refine_indexes_iters, 1)`` passes."""
    params, x = params.detach(), x.detach()
    if search_method == "seqbeam":
        from ..ops.seqbeam import seqbeam_encode_indexes

        return seqbeam_encode_indexes(params, config, x, passes=max(refine_indexes_iters, 1))
    if search_method in ("gramv3", "gramv3-int8"):
        from ..ops.gramv3 import gramv3_encode_indexes

        return gramv3_encode_indexes(
            params, config, x, passes=max(refine_indexes_iters, 1),
            g_dtype="int8" if search_method == "gramv3-int8" else "bf16")
    if search_method not in SEARCH_METHODS:
        raise ValueError(f"unknown search method {search_method!r}")
    return search.compute_indexes(params, config, x, refine_indexes_iters, search=search_method)


def compute_loss(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    refine_indexes_iters: int = 0,
    search_method: str = "beam",
) -> QuantizerLosses:
    """The four loss terms on (*, dim) frames ``x``.  ``search_method``
    selects how the training indexes are found: "beam", "cd", "seqbeam",
    "gramv3" or "gramv3-int8"."""
    x = x.reshape(-1, config.dim)
    cs = config.codebook_size
    indexes = _train_indexes(params, config, x, refine_indexes_iters, search_method).long()

    centers = scaled_centers(params, config.scale_speed)
    x_approx = codec.decode_onehot(centers, indexes)
    tot_err = x_approx - x
    mean = data_mean(params, config.scale_speed)
    rel_reconstruction_loss = (tot_err * tot_err).sum() / (((x - mean) ** 2).sum() + 1.0e-20)

    # negative average log-probability of the refined indexes under the
    # logits head (`quantization/quantization.py:218-225`)
    logits = search.compute_logits(params, config, x)
    logprobs = torch.log_softmax(logits, dim=2)
    logprob_loss = -torch.gather(logprobs, 2, indexes[..., None]).mean()

    # entropy of the empirical index distribution, a diagnostic
    # (`quantization/quantization.py:227-233`)
    with torch.no_grad():
        avg_counts = torch.nn.functional.one_hot(indexes, cs).to(x.dtype).mean(dim=0) + 1.0e-20
        index_entropy = -(avg_counts * torch.log(avg_counts)).sum(dim=1).mean()

    # entropy of the average predicted distribution, differentiable
    # (`quantization/quantization.py:235-236`)
    probs = torch.exp(logprobs).mean(dim=0) + 1.0e-20
    logits_entropy = -(probs * torch.log(probs)).sum(dim=1).mean()

    ref_entropy = math.log(cs)
    return QuantizerLosses(
        rel_reconstruction_loss=rel_reconstruction_loss,
        logprob_loss=logprob_loss,
        logits_entropy_loss=(ref_entropy - logits_entropy) / ref_entropy,
        index_entropy_loss=(ref_entropy - index_entropy) / ref_entropy,
    )
