"""Plain reference of the quantizer's encode, decode and error.

Written from the algorithm of danpovey/quantization
(`quantization/quantization.py:117-148, 244-305, 308-548`), in plain
PyTorch float32 with TF32 off: each entry point turns TF32 off for its own
duration and restores what it found, whatever the process set before.  It
imports nothing of the program and takes nothing the program made: it
reads the quantizer file itself and works out the scaled codebooks, the
logits and every table again.

``cast`` lowers the operands of every inner product over dim (the logits,
the cross terms, the squared norms and the pair products) to another
precision and back, for the control run that has to fail the check.
"""

from __future__ import annotations

import contextlib
import functools
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]
PARAMS = ("centers", "to_logits_w", "to_logits_b", "logits_scale", "centers_scale")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in float32 products and convolutions set to ``on`` for the
    duration, then restored."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def exact(fn):
    """``fn`` run with TF32 off, unless its caller passes ``allow_tf32=True``
    (the control run)."""

    @functools.wraps(fn)
    def run(*args, allow_tf32: bool = False, **kw):
        with tf32(allow_tf32):
            return fn(*args, **kw)

    return run


def load(path, device) -> Dict[str, torch.Tensor]:
    """The five parameters of a quantizer ``.npz`` and its scale speed."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        out = {k: torch.from_numpy(np.array(z[k], np.float32)).to(device) for k in PARAMS}
    out["scale_speed"] = float(meta["scale_speed"])
    return out


def scaled_centers(p: Dict) -> torch.Tensor:
    """(nc, cs, dim) codebooks times exp(centers_scale * speed)."""
    return torch.exp(p["centers_scale"] * p["scale_speed"]) * p["centers"]


def data_mean(p: Dict) -> torch.Tensor:
    """The quantizer's estimate of the data mean: each codebook's mean
    codeword, summed over codebooks."""
    return scaled_centers(p).mean(dim=1).sum(dim=0)


def logits(p: Dict, x: torch.Tensor, cast: Cast = None) -> torch.Tensor:
    """(B, nc, cs) index-prediction logits."""
    nc, cs, _ = p["centers"].shape
    c = cast or (lambda t: t)
    scale = torch.exp(p["logits_scale"] * p["scale_speed"])
    out = c(scale * x) @ c(p["to_logits_w"]).t() + p["to_logits_b"]
    return out.reshape(x.shape[0], nc, cs)


def k_cutoff(cs: int, L: int) -> int:
    """Options kept a choice: 8 (cs <= 16) or 16, doubled each time L
    quadruples, at most 128."""
    k = 8 if cs <= 16 else 16
    while L >= 4:
        L //= 4
        k *= 2
    return min(k, 128)


def _pick(t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """t[b, n, sel[b, n, k]] for t (B, N, K, ...) and sel (B, N, k)."""
    shape = sel.shape + t.shape[3:]
    idx = sel.reshape(*sel.shape, *([1] * (t.dim() - 3))).expand(shape)
    return torch.gather(t, 2, idx)


def refine(centers: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
           cast: Cast = None) -> torch.Tensor:
    """One pass of the pair-tree beam search from (B, nc) indexes ``idx``.

    N choices of K options over L codebooks each, from (nc, cs, 1): prune a
    choice to its k_cutoff best options, or combine pairs of choices
    (N/2, K*K, 2L) by (a+b+c)^2 = (a+b)^2 + (a+c)^2 - a^2 + 2 b.c, with a
    the current error and b, c the two options' changes; until one option
    is left."""
    c = cast or (lambda t: t)
    nc, cs, dim = centers.shape
    B = x.shape[0]
    old = centers[torch.arange(nc, device=x.device), idx]  # (B, nc, dim)
    err = old.sum(dim=1) - x
    rem = err[:, None, :] - old  # the error without codebook n's codeword
    rem_c, cen_c = c(rem), c(centers)
    sumsq = ((rem_c * rem_c).sum(-1)[:, :, None] + (cen_c * cen_c).sum(-1)[None]
             + 2.0 * torch.einsum("bnd,nkd->bnk", rem_c, cen_c))
    err_c = c(err)
    err_sumsq = (err_c * err_c).sum(-1)[:, None, None]
    N, K, L = nc, cs, 1
    # each option's codebook indexes, and its change to the reconstruction:
    # ("codebook",) before any prune, ("pair", even, odd, K_old) after a
    # combine, ("rows", deltas) after a prune
    opt = torch.arange(cs, device=x.device)[None, None, :, None].expand(B, nc, cs, 1)
    state = ("codebook",)

    def deltas_of(sel):
        if state[0] == "codebook":
            picked = centers[torch.arange(N, device=x.device)[None, :, None], sel]
            return picked - old[:, :, None, :]
        if state[0] == "pair":
            _, even, odd, k_old = state
            return _pick(even, sel // k_old) + _pick(odd, sel % k_old)
        return _pick(state[1], sel)

    while True:
        kc = k_cutoff(cs, L)
        if N == 1 and K == 1:
            return opt[:, 0, 0, :].to(torch.int64)
        if K > kc or N == 1:
            new_k = 1 if N == 1 else kc
            sumsq, sel = torch.topk(sumsq, new_k, dim=-1, largest=False)
            opt = _pick(opt, sel)
            if N > 1:
                state = ("rows", deltas_of(sel))
            K = new_k
            continue
        if state[0] != "rows":
            every = torch.arange(K, device=x.device)[None, None, :].expand(B, N, K)
            state = ("rows", deltas_of(every))
        d = state[1]
        even, odd = d[:, 0::2], d[:, 1::2]
        bc = torch.einsum("bnkd,bnjd->bnkj", c(even), c(odd))
        sumsq = (sumsq[:, 0::2, :, None] + sumsq[:, 1::2, None, :]
                 + 2.0 * bc).reshape(B, N // 2, K * K) - err_sumsq
        oe, oo = opt[:, 0::2], opt[:, 1::2]
        opt = torch.cat([oe[:, :, :, None].expand(B, N // 2, K, K, L).reshape(B, N // 2, K * K, L),
                         oo[:, :, None].expand(B, N // 2, K, K, L).reshape(B, N // 2, K * K, L)],
                        dim=3)
        state = ("pair", even, odd, K)
        N, K, L = N // 2, K * K, 2 * L


@exact
def encode_indexes(p: Dict, x: torch.Tensor, passes: int = 5, cast: Cast = None) -> torch.Tensor:
    """(B, nc) indexes: the logits' argmax, then ``passes`` beam passes."""
    idx = torch.argmax(logits(p, x, cast), dim=-1)
    centers = scaled_centers(p)
    for _ in range(passes):
        idx = refine(centers, x, idx, cast)
    return idx


def unpack(codes: torch.Tensor, cs: int, nc: int) -> torch.Tensor:
    """(B, nc) indexes from (B, bytes) codes: a byte holds one index of
    256, or two of 16 (low first)."""
    codes = codes.to(torch.int64)
    if codes.shape[-1] == nc:
        return codes
    per = nc // codes.shape[-1]
    if cs ** per > 256 or codes.shape[-1] * per != nc:
        raise ValueError(f"codes of width {codes.shape[-1]} do not hold {nc} indexes of {cs}")
    parts = [(codes // cs ** j) % cs for j in range(per)]
    return torch.stack(parts, dim=-1).reshape(codes.shape[0], nc)


def decode(p: Dict, idx: torch.Tensor) -> torch.Tensor:
    """(B, dim) reconstruction: the sum of the chosen codewords."""
    centers = scaled_centers(p)
    nc = centers.shape[0]
    return centers[torch.arange(nc, device=idx.device), idx].sum(dim=1)


@exact
def frame_sse(p: Dict, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B,) squared reconstruction error of each frame, in float64."""
    d = (decode(p, idx) - x).double()
    return (d * d).sum(dim=-1)


@exact
def spread_sumsq(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """sum over frames of |x - data_mean|^2, the denominator of the
    relative error, in float64."""
    d = (x - data_mean(p)).double()
    return (d * d).sum()


def pack(idx: torch.Tensor, cs: int) -> torch.Tensor:
    """(B, bytes) uint8 codes of (B, nc) indexes: pairs of indexes of 16
    share a byte (low first) while cs * cs <= 256."""
    idx = idx.to(torch.int64)
    while cs * cs <= 256:
        idx = idx[:, 0::2] + cs * idx[:, 1::2]
        cs *= cs
    return idx.to(torch.uint8)
