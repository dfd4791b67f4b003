"""Parameter interop: numpy arrays and the reference's state dict.

``params_from_numpy`` takes the JAX package's ``QuantizerParams`` fields as
numpy arrays (``centers``, ``to_logits_w``, ``to_logits_b``,
``logits_scale``, ``centers_scale``) and returns the port's
:class:`QuantizerParams`; ``params_to_numpy`` is its inverse.
The ``.npz`` loader goes through them.  ``multi_kmeans_params_from_numpy``
and ``joint_codebook_params_from_numpy`` take the auxiliary models' fields
the same way.  The tests use all of them to give both packages identical
parameters.

The reference persists quantizers as ``torch.save(quantizer.state_dict())``
(`quantization/test_train_hdf5.py:47-54`) with the keys
``to_logits.weight``, ``to_logits.bias``, ``centers``, ``logits_scale``,
``centers_scale`` and ``id_buf`` (`quantization/quantization.py:38-59`);
:class:`Quantizer` has exactly these, so ``.pt`` files go through
``state_dict()`` / ``load_state_dict()`` (``to_torch_state_dict`` gives
the dict that ``save_torch_quantizer`` writes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.types import QuantizerParams
from ..models.quantizer import Quantizer

PARAM_FIELDS = ("centers", "to_logits_w", "to_logits_b", "logits_scale", "centers_scale")


def params_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> QuantizerParams:
    """Port parameters (float32 tensors on ``device``, default CPU) from the
    JAX package's parameter fields as numpy arrays."""
    t = {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
         for k in PARAM_FIELDS}
    nc, cs, dim = t["centers"].shape
    if t["to_logits_w"].shape != (nc * cs, dim) or t["to_logits_b"].shape != (nc * cs,):
        raise ValueError(f"inconsistent parameter shapes {[tuple(v.shape) for v in t.values()]}")
    t["logits_scale"] = t["logits_scale"].reshape(())
    t["centers_scale"] = t["centers_scale"].reshape(())
    return QuantizerParams(**t)


def params_to_numpy(params: QuantizerParams) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_numpy`: float32 numpy arrays."""
    return {k: getattr(params, k).detach().cpu().float().numpy() for k in PARAM_FIELDS}


def multi_kmeans_params_from_numpy(arrays: Dict[str, np.ndarray], device=None):
    """Port :class:`~quantization_tpu_torch.models.multi_kmeans.MultiKmeansParams`
    (float32 on ``device``, default CPU) from the JAX package's fields as
    numpy arrays (``centers``, ``frame_entropy_scale``)."""
    from ..models.multi_kmeans import MultiKmeansParams

    centers = torch.from_numpy(np.array(arrays["centers"], dtype=np.float32)).to(device)
    if centers.ndim != 3:
        raise ValueError(f"centers must be (nc, cs, dim), got {tuple(centers.shape)}")
    scale = torch.from_numpy(np.array(arrays["frame_entropy_scale"], dtype=np.float32))
    return MultiKmeansParams(centers=centers, frame_entropy_scale=scale.reshape(()).to(device))


def joint_codebook_params_from_numpy(arrays: Dict[str, np.ndarray], device=None):
    """Port :class:`~quantization_tpu_torch.models.prediction.JointCodebookParams`
    (float32 on ``device``, default CPU) from the JAX package's fields as
    numpy arrays."""
    from ..models.prediction import JOINT_CODEBOOK_FIELDS, JointCodebookParams

    t = {k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(device)
         for k in JOINT_CODEBOOK_FIELDS}
    nc, cs, hidden = t["linear2_w"].shape
    predictor_channels = t["linear1_w"].shape[1]
    want = {"linear1_w": (hidden, predictor_channels), "linear1_b": (hidden,),
            "embedding": ((nc - 1) * cs, hidden), "linear2b_w": (nc, cs, predictor_channels),
            "linear2_b": (nc, cs)}
    bad = {k: tuple(t[k].shape) for k, shape in want.items() if tuple(t[k].shape) != shape}
    if bad:
        raise ValueError(f"inconsistent parameter shapes {bad}, expected {want}")
    return JointCodebookParams(**t)


def quantizer_from_state_dict(state_dict: dict, device=None) -> Quantizer:
    """A :class:`Quantizer` from a reference-format state dict."""
    sd = {k: torch.as_tensor(v).detach().cpu() for k, v in state_dict.items()}
    nc, cs, dim = sd["centers"].shape
    params = QuantizerParams(
        centers=sd["centers"].float(),
        to_logits_w=sd["to_logits.weight"].float(),
        to_logits_b=sd["to_logits.bias"].float(),
        logits_scale=sd["logits_scale"].float().reshape(()),
        centers_scale=sd["centers_scale"].float().reshape(()),
    )
    id_str = bytes(sd["id_buf"].tolist()).decode("utf-8") if "id_buf" in sd else None
    return Quantizer(dim, cs, nc, params=params, id_str=id_str, device=device)


def load_torch_quantizer(path, device=None) -> Quantizer:
    """Load a reference-format ``quantizer.pt``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return quantizer_from_state_dict(sd, device=device)


def to_torch_state_dict(q: Quantizer) -> dict:
    """The reference-format state dict of ``q``: its ``state_dict()`` as
    CPU tensors, loadable by the reference's
    ``Quantizer(...).load_state_dict``."""
    return {k: v.detach().cpu() for k, v in q.state_dict().items()}


def save_torch_quantizer(path, q: Quantizer) -> None:
    """``torch.save`` a :class:`Quantizer` in the reference's format."""
    torch.save(to_torch_state_dict(q), path)
