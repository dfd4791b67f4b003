"""Functional core of the PyTorch multi-codebook quantizer.

Plain functions over a :class:`QuantizerParams` of tensors and a static
:class:`QuantizerConfig`; they run on the device the tensors are on.  The
``nn.Module`` with the reference's API lives in
:mod:`quantization_tpu_torch.models.quantizer`.
"""

from . import precision  # noqa: F401  (sets the f32 matmul policy)
from .codec import (
    decode,
    decode_indexes,
    decode_onehot,
    encode,
    pack_indexes,
    unpack_indexes,
)
from .diagnostics import codebook_correlations
from .growth import product_params
from .init import init_quantizer_params, init_quantizer_params_from_centers, random_id
from .losses import compute_loss
from .search import (
    compute_indexes,
    compute_logits,
    k_cutoff_schedule,
    refine_indexes,
    refine_indexes_cd,
    search_plan,
)
from .types import (
    QuantizerConfig,
    QuantizerLosses,
    QuantizerParams,
    data_mean,
    resolve_device,
    scaled_centers,
)

__all__ = [
    "QuantizerConfig",
    "QuantizerLosses",
    "QuantizerParams",
    "codebook_correlations",
    "compute_indexes",
    "compute_logits",
    "compute_loss",
    "data_mean",
    "decode",
    "decode_indexes",
    "decode_onehot",
    "encode",
    "init_quantizer_params",
    "init_quantizer_params_from_centers",
    "k_cutoff_schedule",
    "pack_indexes",
    "product_params",
    "random_id",
    "refine_indexes",
    "refine_indexes_cd",
    "resolve_device",
    "scaled_centers",
    "search_plan",
    "unpack_indexes",
]
