from .checkpoint import checkpoint, remat

__all__ = ["checkpoint", "remat", "load_quantizer", "save_quantizer", "profile_device_ops"]


def __getattr__(name):
    # imported when first used: serialization pulls in the model, and the
    # model and core import ``spans`` from here; profiling pulls in
    # torch.profiler, as in the JAX package
    if name in ("load_quantizer", "save_quantizer"):
        from . import serialization

        return getattr(serialization, name)
    if name == "profile_device_ops":
        from .profiling import profile_device_ops

        return profile_device_ops
    raise AttributeError(name)
