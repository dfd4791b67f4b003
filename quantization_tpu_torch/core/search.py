"""Index search: initial logits argmax + iterative beam-search refinement.

PyTorch counterpart of ``quantization_tpu/core/search.py``; the algorithm is
the reference's `_refine_indexes` (`quantization/quantization.py:308-548`).
Maintain N K-way choices, each covering L codebooks.  Alternate pruning
(keep the K_cutoff best options per choice) and combining pairs of choices
(N -> N/2, K -> K^2, L -> 2L) using the recombination identity

    new_sumsq = even_sumsq + odd_sumsq - x_err_sumsq + 2 <even_delta, odd_delta>

until a single best combination remains.  The (N, K, L) schedule depends
only on (num_codebooks, codebook_size), so it is a Python loop here; deltas
are materialized only at K = K_cutoff, and the winning per-codebook indexes
are recovered by a reverse walk over the per-stage selections.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import precision
from .types import LOCAL, QuantizerConfig, QuantizerParams, Reducer, scaled_centers


def k_cutoff_schedule(codebook_size: int, L: int) -> int:
    """Pruning width.  Starts at 8 (codebook_size <= 16) or 16, doubles every
    time L quadruples, capped at 128 (`quantization/quantization.py:453-463`)."""
    k = 8 if codebook_size <= 16 else 16
    l = L
    while l >= 4:
        l //= 4
        k *= 2
    return min(k, 128)


def search_plan(num_codebooks: int, codebook_size: int) -> List[Tuple[str, int, int, int]]:
    """The static (op, N, K, L) schedule executed by :func:`refine_indexes`."""
    plan = []
    N, K, L = num_codebooks, codebook_size, 1
    cs = codebook_size
    while True:
        kc = k_cutoff_schedule(cs, L)
        if N == 1 and K == 1:
            plan.append(("done", N, K, L))
            return plan
        elif K > kc or N == 1:
            new_k = 1 if N == 1 else kc
            plan.append(("prune", N, new_k, L))
            K = new_k
        else:
            plan.append(("combine", N // 2, K * K, L * 2))
            N, K, L = N // 2, K * K, L * 2


def compute_logits(
    params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor,
    reducer: Reducer = LOCAL,
) -> torch.Tensor:
    """Index-prediction logits ``to_logits(exp(logits_scale*speed) * x)``
    (`quantization/quantization.py:277-279`), in full f32.  Returns
    (B, nc, cs).  ``reducer`` sums the product over dim slices (see
    :class:`~quantization_tpu_torch.core.types.Reducer`)."""
    scale = torch.exp(params.logits_scale * config.scale_speed)
    logits = reducer.dims(torch.matmul(scale * x, params.to_logits_w.t())) + params.to_logits_b
    return logits.reshape(x.shape[0], config.num_codebooks, config.codebook_size)


def refine_indexes_reference(
    centers: torch.Tensor, x: torch.Tensor, indexes: torch.Tensor
) -> torch.Tensor:
    """Readable one-pass oracle of :func:`refine_indexes`: the same
    schedule and recombination identity, carrying every option's
    per-codebook indexes (B, N, K, L) and deltas (B, N, K, dim) instead of
    a reverse walk, as the JAX package's ``refine_indexes_reference`` does.

    Args:
      centers: (nc, cs, dim) *scaled* codebook centers.
      x: (B, dim) frames being quantized.
      indexes: (B, nc) current integer choices in [0, cs).

    Returns (B, nc) int32 improved choices.
    """
    nc, cs, dim = centers.shape
    B = x.shape[0]
    idx = indexes.long()

    old_centers = centers[torch.arange(nc, device=x.device)[None, :], idx]  # (B, nc, dim)
    x_err = old_centers.sum(dim=1) - x  # (B, dim)
    x_remaining = x_err[:, None, :] - old_centers  # (B, nc, dim)
    cur_sumsq = ((x_remaining * x_remaining).sum(dim=-1)[:, :, None]
                 + (centers * centers).sum(dim=-1)[None]
                 + 2.0 * torch.einsum("bnd,nkd->bnk", x_remaining, centers))
    x_err_sumsq = (x_err * x_err).sum(dim=-1)[:, None, None]  # (B, 1, 1)

    N, K, L = nc, cs, 1
    # cur_indexes[b, n, k, :]: the codebook indexes of option k of choice n
    cur_indexes = torch.arange(K, device=x.device)[None, None, :, None].expand(B, N, K, 1)
    # deltas of every option: centers[n, k] - old_centers[b, n] at first
    cur_deltas = centers[None] - old_centers[:, :, None, :]  # (B, N, K, dim)
    while True:
        kc = k_cutoff_schedule(cs, L)
        if N == 1 and K == 1:
            return cur_indexes[:, 0, 0, :].to(torch.int32)  # (B, nc)
        if K > kc or N == 1:
            new_k = 1 if N == 1 else kc
            cur_sumsq, sel = torch.topk(cur_sumsq, new_k, dim=-1, largest=False)
            cur_indexes = torch.gather(
                cur_indexes, 2, sel[..., None].expand(B, N, new_k, L))
            cur_deltas = _take(cur_deltas, sel)
            K = new_k
        else:
            # combined option k = k_even * K + k_odd
            # (`quantization/quantization.py:504-547`)
            nN, nK, nL = N // 2, K * K, L * 2
            even_i, odd_i = cur_indexes[:, 0::2], cur_indexes[:, 1::2]
            cur_indexes = torch.cat([
                even_i[:, :, :, None].expand(B, nN, K, K, L).reshape(B, nN, nK, L),
                odd_i[:, :, None].expand(B, nN, K, K, L).reshape(B, nN, nK, L)], dim=3)
            even_d, odd_d = cur_deltas[:, 0::2], cur_deltas[:, 1::2]
            # (a+b+c)^2 = (a+b)^2 + (a+c)^2 - a^2 + 2bc, a = x_err
            # (`quantization/quantization.py:523-535`)
            bc = torch.einsum("bnkd,bnjd->bnkj", even_d, odd_d)
            cur_sumsq = (cur_sumsq[:, 0::2, :, None] + cur_sumsq[:, 1::2, None, :]
                         + 2.0 * bc).reshape(B, nN, nK) - x_err_sumsq
            cur_deltas = (even_d[:, :, :, None] + odd_d[:, :, None]).reshape(B, nN, nK, dim)
            N, K, L = nN, nK, nL


def _take(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """t[b, n, sel[b, n, k], :] for t (B, N, K, dim) and sel (B, N, k)."""
    return torch.gather(t, 2, sel[..., None].expand(*sel.shape, t.shape[-1]))


def _combine_product(even_d: torch.Tensor, odd_d: torch.Tensor) -> torch.Tensor:
    """The beam's inner contraction <even_delta, odd_delta>, (B, N, K, K),
    at the search's inner precision (``precision.SEARCH_INNER_ALLOW_TF32``,
    the JAX package's ``SEARCH_INNER_PRECISION``), set for this product
    alone."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision.SEARCH_INNER_ALLOW_TF32
    try:
        return torch.einsum("bnkd,bnjd->bnkj", even_d, odd_d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def refine_indexes(
    centers: torch.Tensor, x: torch.Tensor, indexes: torch.Tensor, reducer: Reducer = LOCAL
) -> torch.Tensor:
    """One refinement pass of the pair-tree beam search.

    Args:
      centers: (nc, cs, dim) *scaled* codebook centers.
      x: (B, dim) frames being quantized.
      indexes: (B, nc) current integer choices in [0, cs).
      reducer: sums each inner product over dim slices; every device of the
        model axis then takes the same choices.

    Returns (B, nc) int32 improved choices.  Matches the JAX package's
    ``refine_indexes`` except in tie-breaking among equal-error options.
    """
    nc, cs, dim = centers.shape
    B = x.shape[0]
    idx = indexes.long()
    ncs = torch.arange(nc, device=x.device)

    old_centers = centers[ncs[None, :], idx]  # (B, nc, dim)
    x_err = old_centers.sum(dim=1) - x  # (B, dim)
    # error with codebook n's contribution removed
    # (`quantization/quantization.py:403-407`)
    x_remaining = x_err[:, None, :] - old_centers  # (B, nc, dim)
    x_remaining_sumsq = (x_remaining * x_remaining).sum(dim=-1)  # (B, nc)
    centers_sumsq = (centers * centers).sum(dim=-1)  # (nc, cs)
    cross = torch.einsum("bnd,nkd->bnk", x_remaining, centers)
    cur_sumsq = reducer.dims(x_remaining_sumsq[:, :, None] + centers_sumsq[None] + 2.0 * cross)
    x_err_sumsq = reducer.dims((x_err * x_err).sum(dim=-1))[:, None, None]  # (B, 1, 1)

    N, K, L = nc, cs, 1
    # delta states, mirroring the reference's lazy `gather_deltas`
    # (`quantization/quantization.py:436-439, 538-541`):
    #   ("initial",): selections index codebooks directly
    #   ("pending", even_d, odd_d, K_old): post-combine; option k has delta
    #       even_d[k // K_old] + odd_d[k % K_old]
    #   ("mat", deltas): materialized (B, N, K, dim)
    delta_state = ("initial",)
    trace = []  # reverse-walk record: ("prune", sel) / ("combine", K_old)

    def gather_deltas(state, sel):
        if state[0] == "initial":
            picked = centers[torch.arange(N, device=x.device)[None, :, None], sel]
            return picked - old_centers[:, :, None, :]
        if state[0] == "pending":
            _, even_d, odd_d, k_old = state
            return _take(even_d, sel // k_old) + _take(odd_d, sel % k_old)
        return _take(state[1], sel)

    def materialize_all(state, k):
        # only reached at k <= 64, i.e. cs <= 8
        if state[0] == "initial":
            return centers[None] - old_centers[:, :, None, :]
        _, even_d, odd_d, _ = state
        B_, N_, _, dim_ = even_d.shape
        return (even_d[:, :, :, None, :] + odd_d[:, :, None, :, :]).reshape(
            B_, N_, k, dim_
        )

    while True:
        kc = k_cutoff_schedule(cs, L)
        if N == 1 and K == 1:
            break
        elif K > kc or N == 1:
            if N == 1:
                sel = torch.argmin(cur_sumsq, dim=-1)[..., None]  # (B, 1, 1)
                trace.append(("prune", sel))
                K = 1
                continue  # terminal: no deltas needed after the last prune
            cur_sumsq, sel = torch.topk(cur_sumsq, kc, dim=-1, largest=False)
            trace.append(("prune", sel))
            delta_state = ("mat", gather_deltas(delta_state, sel))
            K = kc
        else:
            if delta_state[0] != "mat":
                delta_state = ("mat", materialize_all(delta_state, K))
            deltas = delta_state[1]
            even_d, odd_d = deltas[:, 0::2], deltas[:, 1::2]
            even_s, odd_s = cur_sumsq[:, 0::2], cur_sumsq[:, 1::2]
            nN, nK, nL = N // 2, K * K, L * 2
            # recombination identity (`quantization/quantization.py:523-535`)
            bc = reducer.dims(_combine_product(even_d, odd_d))
            cur_sumsq = (
                even_s[:, :, :, None] + odd_s[:, :, None, :] + 2.0 * bc
            ).reshape(B, nN, nK) - x_err_sumsq
            delta_state = ("pending", even_d, odd_d, K)
            trace.append(("combine", K))
            N, K, L = nN, nK, nL

    # Backtrack: o[b, n] is the option index of choice n, from (B, 1) at the
    # final prune out to (B, nc) codebook indexes at the start.
    op, sel = trace[-1]
    o = sel[:, :, 0]  # (B, 1)
    for op, payload in reversed(trace[:-1]):
        if op == "prune":
            o = torch.gather(payload, 2, o[:, :, None])[:, :, 0]
        else:  # combine with pre-combine width K_old
            o = torch.stack([o // payload, o % payload], dim=2).reshape(B, -1)
    return o.to(torch.int32)


def refine_indexes_cd(
    centers: torch.Tensor, x: torch.Tensor, indexes: torch.Tensor, sweeps: int = 1,
    reducer: Reducer = LOCAL,
) -> torch.Tensor:
    """Exact Gauss-Seidel coordinate descent over codebooks: for each
    codebook in turn, pick the codeword minimizing the reconstruction error
    with all other codebooks' current choices held fixed.  Monotone."""
    nc, cs, dim = centers.shape
    idx = indexes.long()
    for _ in range(sweeps):
        ncs = torch.arange(nc, device=x.device)
        err = centers[ncs[None, :], idx].sum(dim=1) - x  # (B, dim)
        new = []
        for n in range(nc):
            err_n = err - centers[n][idx[:, n]]
            # ||err_n + c_n(k)||^2 = ||err_n||^2 + ||c_n(k)||^2 + 2 err_n.c_n(k)
            scores = reducer.dims((centers[n] * centers[n]).sum(dim=-1)[None, :] + 2.0 * (
                err_n @ centers[n].t()
            ))
            idx_n = torch.argmin(scores, dim=-1)
            err = err_n + centers[n][idx_n]
            new.append(idx_n)
        idx = torch.stack(new, dim=1)
    return idx.to(torch.int32)


def compute_indexes(
    params: QuantizerParams,
    config: QuantizerConfig,
    x: torch.Tensor,
    refine_indexes_iters: int = 3,
    search: str = "beam",
    reducer: Reducer = LOCAL,
) -> torch.Tensor:
    """Deterministic encoding of (B, dim) ``x`` to (B, nc) int32 indexes:
    argmax of the prediction logits followed by ``refine_indexes_iters``
    refinement passes (`quantization/quantization.py:281-305`).  ``search``
    is "beam" (the pair-tree beam) or "cd" (one coordinate-descent sweep per
    iteration).  Under a model axis ``x`` and the codebooks hold this
    device's ``config.dim // reducer.dim_parts`` columns."""
    dim = config.dim // reducer.dim_parts
    if x.ndim != 2 or x.shape[1] != dim:
        raise ValueError(f"expected (B, {dim}) frames, got {tuple(x.shape)}")
    logits = compute_logits(params, config, x, reducer)
    indexes = torch.argmax(logits, dim=-1).to(torch.int32)
    centers = scaled_centers(params, config.scale_speed)
    if search == "beam":
        for _ in range(refine_indexes_iters):
            indexes = refine_indexes(centers, x, indexes, reducer)
    elif search == "cd":
        indexes = refine_indexes_cd(centers, x, indexes, sweeps=refine_indexes_iters,
                                    reducer=reducer)
    else:
        raise ValueError(f"unknown search method {search!r}")
    return indexes
