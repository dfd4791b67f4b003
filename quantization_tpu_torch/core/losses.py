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

Under a mesh the ``reducer`` (:class:`~.types.Reducer`) sums the partial
sums before each nonlinear function, so that every term is that of the
whole batch: the reconstruction loss is a ratio of two global sums, the
log-probability a global mean, and both entropies are entropies of
distributions averaged over the whole batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import codec, search
from .types import (
    LOCAL,
    QuantizerConfig,
    QuantizerLosses,
    QuantizerParams,
    Reducer,
    data_mean,
    scaled_centers,
)

SEARCH_METHODS = ("beam", "cd", "seqbeam", "gramv3", "gramv3-int8")
KERNEL_SEARCHES = ("seqbeam", "gramv3", "gramv3-int8")


@torch.no_grad()
def _train_indexes(params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor,
                   refine_indexes_iters: int, search_method: str,
                   reducer: Reducer) -> torch.Tensor:
    """The (B, nc) training indexes, found without gradients.  The kernel
    searches take the JAX call's arguments: seqbeam at its defaults (M=16,
    R=8, f32 E, all-pool), gramv3 at M=8, R=4, both with
    ``max(refine_indexes_iters, 1)`` passes.  A kernel needs whole
    codebooks, so under a model axis it runs at full width on the gathered
    codebooks and frames."""
    params, x = params.detach(), x.detach()
    if search_method in KERNEL_SEARCHES and reducer.dim_parts > 1:
        params = dataclasses.replace(params, centers=reducer.gather_dims(params.centers),
                                     to_logits_w=reducer.gather_dims(params.to_logits_w))
        x = reducer.gather_dims(x)
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
    return search.compute_indexes(params, config, x, refine_indexes_iters, search=search_method,
                                  reducer=reducer)


def compute_loss(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    refine_indexes_iters: int = 0,
    search_method: str = "beam",
    reducer: Reducer = LOCAL,
) -> QuantizerLosses:
    """The four loss terms on (*, dim) frames ``x``.  ``search_method``
    selects how the training indexes are found: "beam", "cd", "seqbeam",
    "gramv3" or "gramv3-int8".  Under a mesh ``x`` holds this device's rows
    and dim columns, and ``reducer`` makes each term the whole batch's."""
    x = x.reshape(-1, config.dim // reducer.dim_parts)
    cs = config.codebook_size
    indexes = _train_indexes(params, config, x, refine_indexes_iters, search_method,
                             reducer).long()

    centers = scaled_centers(params, config.scale_speed)
    x_approx = codec.decode_onehot(centers, indexes)
    tot_err = x_approx - x
    mean = data_mean(params, config.scale_speed)
    sums = reducer.rows(reducer.dims(torch.stack([(tot_err * tot_err).sum(),
                                                  ((x - mean) ** 2).sum()])))
    rel_reconstruction_loss = sums[0] / (sums[1] + 1.0e-20)

    # negative average log-probability of the refined indexes under the
    # logits head (`quantization/quantization.py:218-225`)
    logits = search.compute_logits(params, config, x, reducer)
    logprobs = torch.log_softmax(logits, dim=2)
    logprob_loss = -reducer.mean(torch.gather(logprobs, 2, indexes[..., None]))

    # entropy of the empirical index distribution, a diagnostic
    # (`quantization/quantization.py:227-233`)
    with torch.no_grad():
        avg_counts = reducer.mean(torch.nn.functional.one_hot(indexes, cs).to(x.dtype),
                                  dim=0) + 1.0e-20
        index_entropy = -(avg_counts * torch.log(avg_counts)).sum(dim=1).mean()

    # entropy of the average predicted distribution, differentiable
    # (`quantization/quantization.py:235-236`)
    probs = reducer.mean(torch.exp(logprobs), dim=0) + 1.0e-20
    logits_entropy = -(probs * torch.log(probs)).sum(dim=1).mean()

    ref_entropy = math.log(cs)
    return QuantizerLosses(
        rel_reconstruction_loss=rel_reconstruction_loss,
        logprob_loss=logprob_loss,
        logits_entropy_loss=(ref_entropy - logits_entropy) / ref_entropy,
        index_entropy_loss=(ref_entropy - index_entropy) / ref_entropy,
    )
