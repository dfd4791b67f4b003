"""The Gram-table kernel (K3) at 16 codebooks on seeded codebooks at dim
1280: every index against the plain version (bf16 and int8 tables; B 1,
63, 8,192 and 8,193), then at 8,192 frames the kernel's device time at
auto's beam (M=8, R=4, altparity) for 3, 4 and 5 passes beside its bound
(and the plain version's at 3), its registers and blocks an SM, and the
stage-timed build's breakdown.
Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.gramv3_nc16 [--out FILE]

Run as a file, it takes ``quantization_tpu_torch`` from ``PYTHONPATH``, so
another checkout's kernel (another layout of its shared rows) is measured on
the same problems in the same run:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/gramv3_nc16.py
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from quantization_tpu_torch.core.types import QuantizerConfig
from quantization_tpu_torch.ops import cuda_build
from quantization_tpu_torch.ops import gramv3 as K3
from quantization_tpu_torch.utils.device import device_ms, nvidia_smi_line
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

DIM, NC = 1280, 16
CHECK_SIZES = (1, 63, 8192, 8193)
TIME_B = 8192
BEAM = dict(M=8, R=4, pool_mask="altparity")
F32_ADDS_PER_S = 33.5e12  # the H100's FP32 add rate, as chip_smoke.py's bounds


def seeded(frames: int, device, seed: int = 16):
    """Seeded d1280 / 16 codebooks (normal x 0.5), logits weights near
    them, and ``frames`` frames near their sums: (params, config, x)."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((NC, 256, DIM)) * 0.5).astype(np.float32)
    arrays = {"centers": centers,
              "to_logits_w": (centers.reshape(NC * 256, DIM)
                              + 0.5 * rng.standard_normal((NC * 256, DIM))).astype(np.float32),
              "to_logits_b": np.zeros(NC * 256, np.float32),
              "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0)}
    x = (centers[np.arange(NC)[None], rng.integers(0, 256, (frames, NC))].sum(1)
         + 4.0 * rng.standard_normal((frames, DIM))).astype(np.float32)
    return (params_from_numpy(arrays, device=device), QuantizerConfig(DIM, 256, NC),
            torch.from_numpy(x).to(device))


def bound_ms(B: int, passes: int, M: int, g_dtype: str) -> float:
    """The least time of the kernel's f32 adds (benchmark/counts/gramv3.py's
    count): bf16 adds every candidate's nc rows, int8 the shared rows once
    a step."""
    if g_dtype == "int8":
        rows = NC + sum(M * t + NC - t for t in range(1, NC))
    else:
        rows = (1 + (NC - 1) * M) * NC
    return B * passes * rows * 256 / F32_ADDS_PER_S * 1e3


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/gramv3_nc16.json"))
    args = ap.parse_args(argv)
    card = nvidia_smi_line()
    print(card, flush=True)
    built = cuda_build.build(["gramv3", "logits_argmax"])
    print(f"[build] {built:.1f} s", flush=True)
    params, config, x_all = seeded(max(CHECK_SIZES), "cuda")
    out = {"card": card, "package": K3.__file__, "checks": [], "times": []}
    for g in ("bf16", "int8"):
        for B in CHECK_SIZES:
            p = K3.gramv3_problem(params, config, x_all[:B], passes=3, g_dtype=g, **BEAM)
            got, want = K3.gramv3_cuda(p), K3.gramv3_plain(p)
            eq = float((got == want).float().mean())
            out["checks"].append({"g_dtype": g, "B": B, "index_agreement": eq,
                                  "equal": bool(torch.equal(got, want))})
            print(f"[check {g} B={B}] indexes equal to plain: {torch.equal(got, want)} "
                  f"(agreement {eq:.6f})", flush=True)
    x = x_all[:TIME_B]
    for g in ("bf16", "int8"):
        for passes in (3, 4, 5):
            p = K3.gramv3_problem(params, config, x, passes=passes, g_dtype=g, **BEAM)
            ms = device_ms(lambda: K3.gramv3_cuda(p), 10)
            b = bound_ms(TIME_B, passes, BEAM["M"], g)
            occ = K3.gramv3_occupancy(p)
            entry = {"g_dtype": g, "passes": passes, "B": TIME_B, "ms": ms, "bound_ms": b,
                     "roofline_pct": 100.0 * b / ms, **occ}
            if passes == 3:
                entry["plain_ms"] = device_ms(lambda: K3.gramv3_plain(p), 2)
            out["times"].append(entry)
            print(f"[time {g} passes={passes}] {ms:.4f} ms, bound {b:.4f} ms "
                  f"({100 * b / ms:.1f}%); {occ['registers']} registers, "
                  f"{occ['blocks_per_sm']} blocks an SM"
                  + (f"; plain {entry['plain_ms']:.3f} ms" if passes == 3 else ""), flush=True)
    from quantization_tpu_torch.experiments.gramv3_times import stage_breakdown

    p = K3.gramv3_problem(params, config, x, passes=3, g_dtype="bf16", **BEAM)
    out["stages_bf16"] = stage_breakdown(p)
    print(f"[stages bf16 passes=3] {out['stages_bf16']['summary']}", flush=True)
    out["ptxas"] = [l.strip() for l in cuda_build.build_log("gramv3").splitlines()]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
