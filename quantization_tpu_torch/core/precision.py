"""Matmul precision policy.

The reference computes in CUDA f32, and the JAX package asks every core
contraction for ``Precision.HIGHEST``.  On the GPU the counterpart is to
keep TF32 off for both matmuls and convolutions, which this module sets
when it is imported (``core`` imports it first).  The hand-written kernels
choose bf16 or int8 operands deliberately, never by accident.

One product takes the tensor cores deliberately: the Gram-table encode's
``XC`` and Gram table (``ops/gramv3.py::bf16_product``), whose operands are
bf16 values, as the JAX package computes them (``jnp.dot`` of bf16 with f32
output).  Their products are exact there; only the order of the f32 sums
moves.  Where the card's torch has no ``torch.mm(..., out_dtype=)``, that
product allows TF32 in a local scope and restores the setting.
"""

from __future__ import annotations

import torch

# f32 matmuls run in full f32 (no TF32), like the JAX package's HIGHEST.
MATMUL_ALLOW_TF32: bool = False
CUDNN_ALLOW_TF32: bool = False

torch.backends.cuda.matmul.allow_tf32 = MATMUL_ALLOW_TF32
torch.backends.cudnn.allow_tf32 = CUDNN_ALLOW_TF32
