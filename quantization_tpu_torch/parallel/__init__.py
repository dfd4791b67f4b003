"""Multi-device runs: a process-group mesh, its sharding builders, and bulk
encode and decode split over the mesh's 'data' axis (PyTorch counterpart of
``quantization_tpu/parallel``).  One process drives each device; see
:mod:`.mesh`."""

from .bulk import decode_sharded, encode_sharded
from .mesh import (
    Mesh,
    batch_only_sharding,
    data_sharding,
    gather_params,
    init_distributed,
    make_mesh,
    quantizer_param_sharding,
    replicated_sharding,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "batch_only_sharding",
    "decode_sharded",
    "encode_sharded",
    "data_sharding",
    "gather_params",
    "init_distributed",
    "make_mesh",
    "quantizer_param_sharding",
    "replicated_sharding",
    "shard_batch",
    "shard_params",
]
