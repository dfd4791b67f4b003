"""Hopper counterparts of the JAX package's ``experiments/`` probes.

Each module here is named after the script it ports and is an entry point
that runs on a CUDA card:

    python -m quantization_tpu_torch.experiments.prim_bench
    python -m quantization_tpu_torch.experiments.int8_mxu_probe

Importing a module runs nothing; its kernels build at their first launch.
"""
