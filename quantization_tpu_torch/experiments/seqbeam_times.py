"""Device times of the seqbeam kernels on beams of seeded codebooks: for
each beam of BEAMS (impl, E type, M, dim: the f32-E beams from M=24 that
take the full layout, then the beams of auto's two rungs), FRAMES frames
near 8 seeded codebooks of 256 codewords, R=4, 2 passes ("altparity" for
v2), the kernel's layout where the package reports one and its
milliseconds a call.  Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.seqbeam_times

Run as a file, it takes ``quantization_tpu_torch`` from ``PYTHONPATH``, so
the kernel of another checkout of the package can be timed on the same
problems in the same run:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/seqbeam_times.py
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.core import QuantizerConfig
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.utils.device import device_ms, nvidia_smi_line
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

NC, PASSES, R = 8, 2, 4
BEAMS = (("v2", "f32", 32, 512), ("v2", "f32", 64, 256), ("v1", "f32", 32, 512),
         ("v1", "f32", 24, 768), ("v2", "int8", 8, 512), ("v2", "bf16", 8, 256))
FRAMES = 2048


def seeded_problem(impl: str, e_dtype: str, M: int, dim: int, frames: int, device):
    """A seqbeam problem on NC seeded codebooks of 256 at ``dim`` (normal x
    0.5, seeded by dim + M) and ``frames`` frames near their sums; returns
    the problem and the f32 centers."""
    rng = np.random.default_rng(dim + M)
    centers = (rng.standard_normal((NC, 256, dim)) * 0.5).astype(np.float32)
    arrays = {"centers": centers,
              "to_logits_w": (centers.reshape(NC * 256, dim)
                              + 0.5 * rng.standard_normal((NC * 256, dim))).astype(np.float32),
              "to_logits_b": np.zeros(NC * 256, np.float32),
              "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0)}
    x = (centers[np.arange(NC)[None], rng.integers(0, 256, (frames, NC))].sum(1)
         + 2.0 * rng.standard_normal((frames, dim))).astype(np.float32)
    kw = dict(pool_mask="altparity") if impl == "v2" else {}
    problem = tseq.seqbeam_problem(params_from_numpy(arrays, device=device),
                                   QuantizerConfig(dim, 256, NC), torch.from_numpy(x).to(device),
                                   M=M, R=R, passes=PASSES, e_dtype=e_dtype, impl=impl, **kw)
    return problem, torch.from_numpy(centers).to(device)


@torch.no_grad()
def beam_time(impl: str, e_dtype: str, M: int, dim: int) -> dict:
    problem, _ = seeded_problem(impl, e_dtype, M, dim, FRAMES, "cuda")
    # the package of a checkout from before the spill layout has no seqbeam_layout
    layout = tseq.seqbeam_layout(problem) if hasattr(tseq, "seqbeam_layout") else None
    return {"beam": f"{impl} {e_dtype} E M={M} d{dim}", "frames": FRAMES, "layout": layout,
            "ms": device_ms(lambda: tseq.seqbeam_cuda(problem), 10)}


def main() -> int:
    if not torch.cuda.is_available():
        print("seqbeam_times needs a CUDA card", file=sys.stderr)
        return 1
    print(f"package {pathlib.Path(qtt.__file__).parent}; {nvidia_smi_line()}", flush=True)
    for beam in BEAMS:
        print(json.dumps(beam_time(*beam)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
