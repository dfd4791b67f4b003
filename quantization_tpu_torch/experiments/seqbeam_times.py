"""Device times of the seqbeam kernels on beams of seeded codebooks: for
each beam of BEAMS (the f32-E beams from M=24 that take the full layout,
v1 at the JAX wrapper's M=16, R=8, the training search's f32-E beam at its
batch, an f32-E beam whose frames a block the full layout halves and one
that takes the compact layout, then the beams of auto's two rungs), frames
near 8 seeded codebooks
of 256 codewords (FRAMES, R=4 and 2 passes unless the beam says otherwise;
"altparity" for v2 but the training search's), the kernel's layout where
the package reports one and its milliseconds a call.  Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.seqbeam_times

Run as a file, it takes ``quantization_tpu_torch`` from ``PYTHONPATH``, so
the kernel of another checkout of the package can be timed on the same
problems in the same run:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/seqbeam_times.py
"""

from __future__ import annotations

import collections
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
FRAMES = 2048
Beam = collections.namedtuple("Beam", "impl e_dtype M dim R passes frames pool_mask",
                              defaults=(R, PASSES, FRAMES, "altparity"))
BEAMS = (Beam("v2", "f32", 32, 512), Beam("v2", "f32", 64, 256), Beam("v1", "f32", 32, 512),
         Beam("v1", "f32", 24, 768), Beam("v1", "f32", 16, 512, R=8),
         Beam("v2", "f32", 16, 512, R=8, passes=1, frames=600, pool_mask=None),  # training
         Beam("v1", "f32", 8, 256), Beam("v2", "f32", 32, 640),  # F halved; compact
         Beam("v2", "int8", 8, 512), Beam("v2", "bf16", 8, 256))


def seeded_problem(impl: str, e_dtype: str, M: int, dim: int, frames: int, device, R: int = R,
                   passes: int = PASSES, pool_mask="altparity"):
    """A seqbeam problem on NC seeded codebooks of 256 at ``dim`` (normal x
    0.5, seeded by dim + M) and ``frames`` frames near their sums (v2 with
    ``pool_mask``); returns the problem and the f32 centers."""
    rng = np.random.default_rng(dim + M)
    centers = (rng.standard_normal((NC, 256, dim)) * 0.5).astype(np.float32)
    arrays = {"centers": centers,
              "to_logits_w": (centers.reshape(NC * 256, dim)
                              + 0.5 * rng.standard_normal((NC * 256, dim))).astype(np.float32),
              "to_logits_b": np.zeros(NC * 256, np.float32),
              "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0)}
    x = (centers[np.arange(NC)[None], rng.integers(0, 256, (frames, NC))].sum(1)
         + 2.0 * rng.standard_normal((frames, dim))).astype(np.float32)
    kw = dict(pool_mask=pool_mask) if impl == "v2" else {}
    problem = tseq.seqbeam_problem(params_from_numpy(arrays, device=device),
                                   QuantizerConfig(dim, 256, NC), torch.from_numpy(x).to(device),
                                   M=M, R=R, passes=passes, e_dtype=e_dtype, impl=impl, **kw)
    return problem, torch.from_numpy(centers).to(device)


@torch.no_grad()
def beam_time(b: Beam) -> dict:
    problem, _ = seeded_problem(b.impl, b.e_dtype, b.M, b.dim, b.frames, "cuda", b.R, b.passes,
                                b.pool_mask)
    # the package of a checkout from before the spill layout has no seqbeam_layout
    layout = tseq.seqbeam_layout(problem) if hasattr(tseq, "seqbeam_layout") else None
    return {"beam": f"{b.impl} {b.e_dtype} E M={b.M} R={b.R} d{b.dim} passes={b.passes}"
                    + (f" {b.pool_mask}" if b.impl == "v2" and b.pool_mask else ""),
            "frames": b.frames, "layout": layout,
            "ms": device_ms(lambda: tseq.seqbeam_cuda(problem), 10)}


def main() -> int:
    if not torch.cuda.is_available():
        print("seqbeam_times needs a CUDA card", file=sys.stderr)
        return 1
    print(f"package {pathlib.Path(qtt.__file__).parent}; {nvidia_smi_line()}", flush=True)
    for beam in BEAMS:
        print(json.dumps(beam_time(beam)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
