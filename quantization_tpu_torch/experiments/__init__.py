"""Hopper counterparts of the JAX package's ``experiments/`` probes, a check
of the seqbeam kernel against its plain version, and the device times of
the seqbeam and Gram-table kernels.

Each probe module is named after the script it ports; every module here is
an entry point that runs on a CUDA card:

    python -m quantization_tpu_torch.experiments.prim_bench
    python -m quantization_tpu_torch.experiments.int8_mxu_probe
    python -m quantization_tpu_torch.experiments.seqbeam_agreement
    python -m quantization_tpu_torch.experiments.seqbeam_times
    python -m quantization_tpu_torch.experiments.gramv3_times

Importing a module runs nothing; its kernels build at their first launch.
"""
