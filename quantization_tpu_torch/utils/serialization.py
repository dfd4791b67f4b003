"""Quantizer save/load.

``.npz`` files use the JAX package's layout (a ``meta`` JSON blob with the
config and identity, plus the five parameter arrays), so the trained
quantizers in ``experiments/`` load directly; ``.pt``/``.pth`` files are the
reference's ``torch.save(state_dict)`` format (utils/torch_interop.py).
"""

from __future__ import annotations

import io
import json
import os
from typing import Union

import numpy as np

from ..models.quantizer import Quantizer
from .torch_interop import (
    load_torch_quantizer,
    params_from_numpy,
    params_to_numpy,
    save_torch_quantizer,
)

_FORMAT_VERSION = 1


def save_quantizer(path: Union[str, os.PathLike], quantizer: Quantizer) -> None:
    if str(path).endswith((".pt", ".pth")):
        save_torch_quantizer(path, quantizer)
        return
    meta = dict(
        format_version=_FORMAT_VERSION,
        id_str=quantizer.get_id(),
        dim=quantizer.config.dim,
        codebook_size=quantizer.config.codebook_size,
        num_codebooks=quantizer.config.num_codebooks,
        scale_speed=quantizer.config.scale_speed,
    )
    buf = io.BytesIO()
    np.savez(
        buf,
        meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
        **params_to_numpy(quantizer.params),
    )
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_quantizer(path: Union[str, os.PathLike], device=None) -> Quantizer:
    """Load a ``.npz`` (JAX package layout) or ``.pt`` quantizer onto
    ``device`` (default: the GPU)."""
    if str(path).endswith((".pt", ".pth")):
        return load_torch_quantizer(path, device=device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta["format_version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported quantizer format {meta}")
        params = params_from_numpy({k: z[k] for k in z.files if k != "meta"})
    return Quantizer(
        meta["dim"],
        meta["codebook_size"],
        meta["num_codebooks"],
        params=params,
        id_str=meta["id_str"],
        scale_speed=meta["scale_speed"],
        device=device,
    )
