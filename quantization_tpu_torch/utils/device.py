"""What a measurement records about the card it ran on."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``name, power.limit``) for GPU 0.  A card set below its maximum power
    runs slower under load, so every number kept carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_record() -> dict:
    """Name, count and power limit of the CUDA cards, for a results file."""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
    }
