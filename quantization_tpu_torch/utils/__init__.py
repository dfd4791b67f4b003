from .checkpoint import checkpoint, remat
from .serialization import load_quantizer, save_quantizer

__all__ = ["checkpoint", "remat", "load_quantizer", "save_quantizer", "profile_device_ops"]


def __getattr__(name):
    # imported when first used, as in the JAX package: it pulls in torch.profiler
    if name == "profile_device_ops":
        from .profiling import profile_device_ops

        return profile_device_ops
    raise AttributeError(name)
