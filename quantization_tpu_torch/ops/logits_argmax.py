"""The search kernels' initial indexes on the card: the argmax of each
codebook's logits ``exp(logits_scale * speed) * x . to_logits_w^T +
to_logits_b`` as one hand-written kernel (``csrc/logits_argmax.cu``).

The scale is folded into the weights, ``W' = exp(logits_scale * speed) *
to_logits_w`` in f32, and ``W'`` is split into a TF32 high part and a TF32
remainder (:func:`split_tf32`, round to nearest with ties away from zero, as
``cvt.rna``); the kernel splits the frames the same way and sums the
products ``lo . hi``, ``hi . lo`` and ``hi . hi`` in f32 on the tensor
cores, which is f32-class accuracy (each operand within 2^-22 of its value,
the dropped ``lo . lo`` below 2^-22 of a term).  Then it adds the bias and
takes each codebook's argmax with ``torch.argmax``'s rules (lowest index on
ties, the first NaN as the maximum), and writes only the (B, nc) indexes.

The split weights, in the kernel's layout (:func:`weight_layout`), and the
bias are tables of ``to_logits_w``, ``to_logits_b`` and ``logits_scale``
alone, so :data:`TABLES_CACHE` keeps them per parameter version as the
search kernels keep theirs (``ops/tables_cache.py``).  A trainer changes
them every step and so builds them every step: on the card one launch
(``logits_tables_kernel``, :data:`LOGITS_TABLES_KERNEL`), elsewhere
:func:`logits_tables_plain`, the same bits.

:func:`logits_argmax_plain` is the same split arithmetic in plain PyTorch
(f32 sums in another order), for the tests; the CPU's initial indexes stay
``compute_logits``' argmax (``ops/beam_common.py::initial_indexes``).
:func:`f64_argmax` is the judge both are held to.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.types import QuantizerConfig, QuantizerParams
from .cuda_build import CudaKernel
from .tables_cache import TablesCache

CS = 256  # codewords a codebook: the kernel's tile width
CHUNK = 32  # dims a stage of the kernel; W' and the frames are padded to a multiple
# the judge's margin, of a logit's absolute sum: far above f32's and the split's errors
TAU = 2.0 ** -16

LOGITS_ARGMAX_KERNEL = CudaKernel("logits_argmax", "qtt_logits_argmax_launch",
                                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
LOGITS_TABLES_KERNEL = CudaKernel("logits_argmax", "qtt_logits_tables_launch",
                                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def to_tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); infinities and NaNs pass."""
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)  # an infinity stays one
    return torch.where(v == v, rounded, v)


def split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32 values in f32, with ``hi + lo`` within
    2^-22 |v| of ``v`` (``v - hi`` is exact)."""
    hi = to_tf32(v)
    return hi, to_tf32(v - hi)


# (nc * 256, Dp) -> (nc, Dp / 32, s 4, g 32, h 2, r 8, e 4): codebook, chunk, then
# the kernel's shared-memory image of the chunk, k-step s of core matrices
# (8 rows r of group g, 4 elements e of K half h), row 8g + r holding dim
# 32 chunk + 8e + 2s + h (the dim order that lets a lane read its frame
# elements of 4 k-steps from 8 consecutive floats).  The permutation is its
# own inverse.
_LAYOUT = (0, 3, 5, 1, 6, 2, 4)


def weight_layout(w: torch.Tensor) -> torch.Tensor:
    """(nc * 256, Dp) weights, Dp a multiple of 32, in the kernel's layout."""
    K, Dp = w.shape
    return w.reshape(K // CS, 32, 8, Dp // CHUNK, 4, 4, 2).permute(_LAYOUT).contiguous()


def weight_unlayout(laid: torch.Tensor) -> torch.Tensor:
    """The (nc * 256, Dp) weights of :func:`weight_layout`'s output."""
    nc, chunks = laid.shape[:2]
    return laid.permute(_LAYOUT).reshape(nc * CS, chunks * CHUNK)


@dataclasses.dataclass
class LogitsTables:
    """What the kernel takes from the parameters: ``W'``'s TF32 parts in the
    kernel's layout (:func:`weight_layout`; dims padded with zeros to a
    multiple of 32), the f32 bias and the frames' ``dim``, checked here
    (TypeError), once a parameter version, and not at a launch."""

    w_hi: torch.Tensor
    w_lo: torch.Tensor
    bias: torch.Tensor
    dim: int

    def __post_init__(self):
        if not all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in (self.w_hi, self.w_lo, self.bias)):
            raise TypeError("logits tables must be contiguous f32")
        nc, chunks = self.w_hi.shape[:2]
        if (self.w_hi.shape != (nc, chunks, 4, 32, 2, 8, 4) or self.w_lo.shape != self.w_hi.shape
                or self.bias.shape != (nc * CS,) or not 0 <= chunks * CHUNK - self.dim < CHUNK):
            raise TypeError("logits tables must hold both weight parts in the kernel's layout "
                            "for the dim, and a bias a codeword")

    @property
    def padded_dim(self) -> int:
        return self.w_hi.shape[1] * CHUNK


def table_inputs(params: QuantizerParams, scale_speed: float) -> Tuple[torch.Tensor, ...]:
    """The tables' inputs: the scale of ``compute_logits``,
    ``exp(logits_scale * speed)``, ``to_logits_w`` and the bias."""
    return torch.exp(params.logits_scale * scale_speed), params.to_logits_w, params.to_logits_b


def scaled_logits(params: QuantizerParams, scale_speed: float) -> Tuple[torch.Tensor, ...]:
    """``W' = exp(logits_scale * speed) * to_logits_w`` in f32 (the scale
    folded into the weights) and the bias."""
    scale, w, b = table_inputs(params, scale_speed)
    return (scale * w).float(), b


def logits_tables_plain(scale: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> LogitsTables:
    """The tables of (nc * 256, D) weights ``w`` times ``scale`` (one
    value) and their bias, in plain PyTorch on any device."""
    D = w.shape[1]
    w = (scale * w).float()
    if D % CHUNK:
        w = F.pad(w, (0, -D % CHUNK))
    hi, lo = split_tf32(weight_layout(w))  # the split is elementwise: laid out once
    return LogitsTables(hi, lo, b.float().clone(), D)


def logits_tables(scale: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> LogitsTables:
    """:func:`logits_tables_plain`'s tables, on the card by one launch of
    ``logits_tables_kernel`` (equal bit for bit)."""
    if not w.is_cuda:
        return logits_tables_plain(scale, w, b)
    (K, D), Dp = w.shape, w.shape[1] + (-w.shape[1] % CHUNK)
    w = w.float().contiguous()
    scale = scale.float().reshape(1).contiguous()
    parts = torch.empty(2, K // CS, Dp // CHUNK, 4, 32, 2, 8, 4, device=w.device)
    LOGITS_TABLES_KERNEL(w.data_ptr(), scale.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                         K, D, Dp, torch.cuda.current_stream(w.device).cuda_stream)
    return LogitsTables(parts[0], parts[1], b.float().clone(), D)


# an entry at d1280 / 8 codebooks is 21 MB; one a quantizer in use
TABLES_CACHE = TablesCache(4, "logits_argmax", logits_tables,
                           fields=("to_logits_w", "to_logits_b", "logits_scale"),
                           inputs=table_inputs)


def _frames(x: torch.Tensor, tables: LogitsTables) -> torch.Tensor:
    """(B, D) frames as the kernel takes them: f32, dims padded with zeros
    to the tables', contiguous and 16-byte aligned (a copy only where they
    are not).  Raises ValueError for frames of another dim."""
    if x.ndim != 2 or x.shape[1] != tables.dim:
        raise ValueError(f"expected (B, {tables.dim}) frames, got {tuple(x.shape)}")
    x = x.float()
    if x.shape[-1] != tables.padded_dim:
        x = F.pad(x, (0, tables.padded_dim - x.shape[-1]))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def logits_argmax_cuda(x: torch.Tensor, tables: LogitsTables) -> torch.Tensor:
    """The kernel on (B, Dp) f32 frames, contiguous and 16-byte aligned, Dp
    the tables' padded dim: (B, nc) int32 indexes.  Raises ValueError on
    any other input."""
    nc = tables.w_hi.shape[0]
    if not x.is_cuda:
        raise ValueError(f"{LOGITS_ARGMAX_KERNEL.symbol} needs CUDA tensors")
    if (x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != tables.padded_dim
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"logits_argmax needs contiguous 16-byte aligned (B, "
                         f"{tables.padded_dim}) f32 frames, got {x.dtype} {tuple(x.shape)}")
    if tables.w_hi.device != x.device:
        raise ValueError("logits_argmax needs the frames and the tables on one device")
    B = x.shape[0]
    out = torch.empty(B, nc, dtype=torch.int32, device=x.device)
    if B:
        LOGITS_ARGMAX_KERNEL(x.data_ptr(), tables.w_hi.data_ptr(), tables.w_lo.data_ptr(),
                             tables.bias.data_ptr(), out.data_ptr(), B, x.shape[1], nc, CS,
                             torch.cuda.current_stream(x.device).cuda_stream)
    return out


@torch.no_grad()
def logits_argmax_plain(x: torch.Tensor, tables: LogitsTables) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (B, D) frames, on any device:
    the same split of the frames and weights and the same three products,
    summed in f32 in another order; (B, nc) int32 indexes."""
    x_hi, x_lo = split_tf32(_frames(x, tables))
    w_hi, w_lo = weight_unlayout(tables.w_hi), weight_unlayout(tables.w_lo)
    logits = (x_lo @ w_hi.t() + x_hi @ w_lo.t()) + x_hi @ w_hi.t() + tables.bias
    return logits.reshape(x.shape[0], -1, CS).argmax(dim=-1).to(torch.int32)


def logits_argmax(params: QuantizerParams, config: QuantizerConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """(B, nc) int32 initial indexes of (B, dim) CUDA frames by the kernel,
    its tables from :data:`TABLES_CACHE`.  Raises ValueError for a codebook
    size other than the kernel's 256."""
    if config.codebook_size != CS:
        raise ValueError(f"logits_argmax takes {CS} codewords a codebook, "
                         f"got {config.codebook_size}")
    tables = TABLES_CACHE.get(params, config.scale_speed)
    return logits_argmax_cuda(_frames(x, tables), tables)


@torch.no_grad()
def f64_argmax(params: QuantizerParams, config: QuantizerConfig, x: torch.Tensor):
    """The f64 argmax of each codebook's logits ``x . W'^T + b`` (``W'`` the
    f32 scaled weights the tables are built from), and where it is decided:
    the top-two gap above :data:`TAU` x (sum_d |x_d W'_jd| + |b_j|), the
    larger of the two columns'.  Returns ((B, nc) int32 indexes, (B, nc)
    bool)."""
    w, b = scaled_logits(params, config.scale_speed)
    x64, w64, b64 = x.double(), w.double(), b.double()
    B, nc = x.shape[0], config.num_codebooks
    logits = (x64 @ w64.t() + b64).reshape(B, nc, -1)
    size = (x64.abs() @ w64.abs().t() + b64.abs()).reshape(B, nc, -1)
    top, at = logits.topk(2, dim=-1)
    tau = TAU * torch.gather(size, 2, at).amax(dim=-1)
    return at[..., 0].to(torch.int32), (top[..., 0] - top[..., 1]) > tau
