"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper launches its kernel on CUDA tensors and runs the plain
version on CPU tensors; kernels build on first use (ops/cuda_build.py)."""

from .decode import DECODE_KERNEL, DECODE_KERNEL_SUPPORTED, decode_kernel  # noqa: F401
from .seqbeam import SEQBEAM_KERNEL, SEQBEAM_SUPPORTED, seqbeam_encode_indexes  # noqa: F401
