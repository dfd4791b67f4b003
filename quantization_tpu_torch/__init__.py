"""quantization_tpu_torch: the multi-codebook vector quantizer in PyTorch,
with hand-written CUDA kernels for the NVIDIA H100.

A port of ``quantization_tpu`` (JAX/Pallas on the TPU), which stays beside
it as the reference.  This package imports neither JAX nor
``quantization_tpu``.  Entry points run on the GPU unless the caller passes
``device="cpu"``; on CPU tensors the kernels' plain PyTorch versions run.

Public API: Quantizer, QuantizerTrainer, read_hdf5_data, JointCodebookLoss,
checkpoint, remat, load_quantizer, save_quantizer; the command line is
``python -m quantization_tpu_torch`` (``cli.py``).  Multi-device runs are in
``quantization_tpu_torch.parallel``: a process-group mesh, bulk encode and
decode split over it, and the trainer's ``mesh=``.
"""

from . import core
from .models.quantizer import Quantizer
from .utils.checkpoint import checkpoint, remat
from .utils.serialization import load_quantizer, save_quantizer

__version__ = "0.1.0"

__all__ = ["Quantizer", "QuantizerTrainer", "JointCodebookLoss", "read_hdf5_data", "checkpoint",
           "remat", "core", "load_quantizer", "save_quantizer"]


def __getattr__(name):
    # the trainer, the predictor and the data path are imported when first
    # used, as in the JAX package
    if name == "QuantizerTrainer":
        from .train.trainer import QuantizerTrainer

        return QuantizerTrainer
    if name == "JointCodebookLoss":
        from .models.prediction import JointCodebookLoss

        return JointCodebookLoss
    if name == "read_hdf5_data":
        from .data.hdf5 import read_hdf5_data

        return read_hdf5_data
    raise AttributeError(f"module 'quantization_tpu_torch' has no attribute {name!r}")
