"""Hopper counterparts of the JAX package's ``experiments/`` probes, a check
of the seqbeam kernel against its plain version, the device times of the
seqbeam and Gram-table kernels, and the trainer's quality-parity run.

Each probe module, and ``head_to_head``, is named after the script it
ports; every module here is an entry point that runs on a CUDA card
(``head_to_head`` also on the CPU with ``--device cpu``):

    python -m quantization_tpu_torch.experiments.prim_bench
    python -m quantization_tpu_torch.experiments.int8_mxu_probe
    python -m quantization_tpu_torch.experiments.seqbeam_agreement
    python -m quantization_tpu_torch.experiments.seqbeam_times
    python -m quantization_tpu_torch.experiments.gramv3_times
    python -m quantization_tpu_torch.experiments.head_to_head DIM BPF P1 P2 BATCH

Importing a module runs nothing; its kernels build at their first launch.
"""
