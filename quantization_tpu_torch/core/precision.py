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

:func:`set_matmul_precision` and :func:`set_search_inner_precision` take the
JAX package's names (``"highest"``, ``"high"``, ``"default"`` and the other
strings ``jax.lax.Precision`` accepts, its values 0-2, or its members):
``HIGHEST`` keeps TF32 off, the other two allow it.  The search's inner
precision is read by the one contraction that matches the JAX package's
``SEARCH_INNER_PRECISION``: the combine product of the exact beam
(``core/search.py::refine_indexes``).  Both default to f32, where the JAX
package's inner default is ``DEFAULT``: on the GPU the beam keeps the
reference's f32, the precision its quality bars assume.
"""

from __future__ import annotations

import torch

# f32 matmuls run in full f32 (no TF32), like the JAX package's HIGHEST.
MATMUL_ALLOW_TF32: bool = False
CUDNN_ALLOW_TF32: bool = False
# the exact beam's combine product (core/search.py::refine_indexes)
SEARCH_INNER_ALLOW_TF32: bool = False

torch.backends.cuda.matmul.allow_tf32 = MATMUL_ALLOW_TF32
torch.backends.cudnn.allow_tf32 = CUDNN_ALLOW_TF32

# jax.lax.Precision's names and aliases, each to its level
_LEVELS = {"default": "DEFAULT", "fastest": "DEFAULT", "bfloat16": "DEFAULT",
           "high": "HIGH", "bfloat16_3x": "HIGH", "tensorfloat32": "HIGH",
           "highest": "HIGHEST", "float32": "HIGHEST"}
_BY_VALUE = ("DEFAULT", "HIGH", "HIGHEST")


def _allows_tf32(precision) -> bool:
    """Whether a JAX precision (a name, its value or a ``jax.lax.Precision``)
    allows TF32: every level but ``HIGHEST``."""
    if isinstance(precision, str):
        level = _LEVELS.get(precision)
    elif isinstance(precision, int):
        level = _BY_VALUE[precision] if 0 <= precision < len(_BY_VALUE) else None
    else:
        level = getattr(precision, "name", None)
    if level not in _BY_VALUE:
        raise ValueError(f"{precision!r} is not a valid Precision")
    return level != "HIGHEST"


def set_matmul_precision(precision) -> None:
    """The core contractions' precision (``jax`` name or member): TF32 off
    for ``HIGHEST`` (the default), on otherwise, for matmuls and
    convolutions."""
    global MATMUL_ALLOW_TF32, CUDNN_ALLOW_TF32
    MATMUL_ALLOW_TF32 = CUDNN_ALLOW_TF32 = _allows_tf32(precision)
    torch.backends.cuda.matmul.allow_tf32 = MATMUL_ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = CUDNN_ALLOW_TF32


def set_search_inner_precision(precision) -> None:
    """The exact beam's combine product's precision (``jax`` name or
    member): TF32 off for ``HIGHEST`` (the port's default), on otherwise."""
    global SEARCH_INNER_ALLOW_TF32
    SEARCH_INNER_ALLOW_TF32 = _allows_tf32(precision)
