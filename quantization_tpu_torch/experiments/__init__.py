"""Hopper counterparts of the JAX package's ``experiments/`` probes, and a
check of the seqbeam kernel against its plain version.

Each probe module is named after the script it ports; every module here is
an entry point that runs on a CUDA card:

    python -m quantization_tpu_torch.experiments.prim_bench
    python -m quantization_tpu_torch.experiments.int8_mxu_probe
    python -m quantization_tpu_torch.experiments.seqbeam_agreement

Importing a module runs nothing; its kernels build at their first launch.
"""
