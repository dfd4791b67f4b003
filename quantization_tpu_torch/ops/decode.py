"""Fused decode: unpack + gather-sum of bf16 codewords, summed in f32.

Counterpart of ``quantization_tpu/ops/decode.py``.  The TPU kernel turns
each codebook's row pick into a one-hot (B_t, cs) x (cs, D) bf16 matmul
accumulated in f32; as each one-hot row has a single nonzero, it computes
the f32 sum, in codebook order, of bf16-rounded rows.  On the GPU that is a
gather-sum (``csrc/decode.cu``), equal to :func:`decode_plain` bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import codec as _codec
from ..core.types import QuantizerConfig, QuantizerParams, scaled_centers
from ..utils.device import dispatch
from .cuda_build import CudaKernel

DECODE_KERNEL = CudaKernel(
    "decode", "qtt_decode_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def DECODE_KERNEL_SUPPORTED(config: QuantizerConfig) -> bool:
    return (
        config.dim % 128 == 0
        and config.dim >= 128
        and config.codebook_size in (16, 256)
        and config.num_codebooks <= 32
    )


def decode_plain(idx: torch.Tensor, centers_bf16: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, nc) int32 indexes and
    (nc, cs, D) bf16 centers -> (B, D) f32, summed in codebook order from
    zero.  An index outside [0, cs) adds nothing."""
    nc, cs, D = centers_bf16.shape
    out = torch.zeros(idx.shape[0], D, dtype=torch.float32, device=idx.device)
    for n in range(nc):
        i = idx[:, n].long()
        valid = (i >= 0) & (i < cs)
        rows = centers_bf16[n][i.clamp(0, cs - 1)].float()
        out = out + torch.where(valid[:, None], rows, torch.zeros_like(rows))
    return out


def decode_cuda(idx: torch.Tensor, centers_bf16: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the same inputs as :func:`decode_plain`."""
    nc, cs, D = centers_bf16.shape
    if not (idx.is_cuda and centers_bf16.device == idx.device):
        raise ValueError("decode_cuda needs both tensors on one CUDA device")
    if idx.dtype != torch.int32 or centers_bf16.dtype != torch.bfloat16:
        raise TypeError(f"expected int32 indexes and bf16 centers, got {idx.dtype}, "
                        f"{centers_bf16.dtype}")
    if idx.ndim != 2 or idx.shape[1] != nc or D % 8 != 0:
        raise ValueError(f"bad shapes {tuple(idx.shape)}, {tuple(centers_bf16.shape)}")
    idx = idx.contiguous()
    centers_bf16 = centers_bf16.contiguous()
    out = torch.empty(idx.shape[0], D, dtype=torch.float32, device=idx.device)
    DECODE_KERNEL(
        idx.data_ptr(), centers_bf16.data_ptr(), out.data_ptr(),
        idx.shape[0], nc, cs, D, torch.cuda.current_stream(idx.device).cuda_stream,
    )
    return out


def decode_kernel(
    params: QuantizerParams, config: QuantizerConfig, indexes: torch.Tensor
) -> torch.Tensor:
    """Reconstruct (*, dim) float32 from (possibly byte-packed) indexes with
    the bf16 codebooks: the kernel on a CUDA tensor, its plain version on a
    CPU tensor."""
    if not DECODE_KERNEL_SUPPORTED(config):
        raise ValueError(f"decode kernel does not support {config}")
    nc, cs, D = config.num_codebooks, config.codebook_size, config.dim
    lead = indexes.shape[:-1]
    idx = _codec.unpack_indexes(indexes.reshape(-1, indexes.shape[-1]), cs, nc)
    centers = scaled_centers(params, config.scale_speed).to(torch.bfloat16)
    out = dispatch("decode", idx.device, decode_cuda, decode_plain, idx, centers)
    return out.reshape(*lead, D)
