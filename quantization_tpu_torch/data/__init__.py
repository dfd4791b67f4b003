from .synthetic import gaussian_sampler, make_double_sampler, make_mlp_sampler, shannon_distortion

__all__ = [
    "gaussian_sampler",
    "make_double_sampler",
    "make_mlp_sampler",
    "shannon_distortion",
    "read_hdf5_data",
    "write_hdf5_data",
    "ShardStream",
    "write_shards",
    "convert_hdf5_to_shards",
]


def __getattr__(name):
    # imported when first used, as in the JAX package
    if name in ("read_hdf5_data", "write_hdf5_data"):
        from . import hdf5

        return getattr(hdf5, name)
    if name in ("ShardStream", "write_shards", "convert_hdf5_to_shards"):
        from . import shards

        return getattr(shards, name)
    raise AttributeError(name)
