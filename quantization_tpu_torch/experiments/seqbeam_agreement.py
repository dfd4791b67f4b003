"""How closely the seqbeam v2 kernel's indexes follow its plain version on
the auto ladder's two rungs: the trained quantizers in ``experiments/``
(int8 E at d512 / 8 B, three passes; bf16 E at d256 / 4 B, two passes),
M=8, R=4, the "altparity" schedule, on frames of the shipped MLP sampler
from a seed.  Prints one JSON line a rung with ``against_plain``'s numbers
and the count of indexes that differ.  Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.seqbeam_agreement [--frames 32771] [--seed 3]

Run as a file, it takes ``quantization_tpu_torch`` from ``PYTHONPATH``, so
the kernel of another checkout of the package can be given the same
problem:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/seqbeam_agreement.py
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.data.synthetic import make_mlp_sampler
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.ops.quality_guard import against_plain
from quantization_tpu_torch.utils.device import nvidia_smi_line

QUANTIZERS = pathlib.Path(__file__).resolve().parents[2] / "experiments"
RUNGS = {"int8": ("q512_8_full.npz", 3, "int8"), "bf16": ("q256_4_full.npz", 2, "bf16")}


@torch.no_grad()
def rung_agreement(name: str, frames: int, seed: int) -> dict:
    path, passes, e_dtype = RUNGS[name]
    q = qtt.load_quantizer(QUANTIZERS / path, device="cuda")
    x = make_mlp_sampler(q.dim, device="cuda")(torch.Generator().manual_seed(seed), frames)
    problem = tseq.seqbeam_problem(q.params, q.config, x, M=8, R=4, passes=passes,
                                   pool_mask="altparity", e_dtype=e_dtype)
    got = tseq.seqbeam_cuda(problem)
    chk = against_plain(problem, q.get_centers().detach(), got)
    chk["indexes_different"] = int((got != tseq.seqbeam_plain(problem)).sum())
    return {"rung": name, "dim": q.dim, "passes": passes, "seed": seed, **chk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=32768 + 3)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seqbeam_agreement needs a CUDA card", file=sys.stderr)
        return 1
    print(f"package {pathlib.Path(qtt.__file__).parent}; {nvidia_smi_line()}", flush=True)
    for name in RUNGS:
        print(json.dumps(rung_agreement(name, args.frames, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
