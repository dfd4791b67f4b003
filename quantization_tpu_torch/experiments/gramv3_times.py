"""Device times of the Gram-table kernel (K3) on the serving path's beams:
the five configs of ``chip_smoke.py``'s phase 5 (5 passes, M=8, R=4, on
32,768 frames of the key-42 MLP sampler through the two trained
quantizers) and the training search's two (d512, 1 pass, 600 frames), with
each one's precompute (``gramv3_problem``); beside them the seqbeam beams
that must not move, from ``experiments/seqbeam_times.py``: auto's two rungs
and v1 at M=16, R=8.  Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.gramv3_times [--stages]

``--stages`` adds, at d512 bf16, d512 int8 and d256 bf16, the stage-timed
build's breakdown (:func:`stage_breakdown`) and the precompute's split
(:func:`precompute_split`).  Run as a file, it takes
``quantization_tpu_torch`` from ``PYTHONPATH``, so the kernel of another
checkout of the package can be timed on the same problems in the same run:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/gramv3_times.py
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.data.synthetic import make_mlp_sampler
from quantization_tpu_torch.experiments.seqbeam_times import BEAMS, beam_time
from quantization_tpu_torch.ops import gramv3 as K3
from quantization_tpu_torch.utils.device import device_ms, nvidia_smi_line

ROOT = pathlib.Path(__file__).resolve().parents[2]
TRAINED = {512: ROOT / "experiments/q512_8_full.npz", 256: ROOT / "experiments/q256_4_full.npz"}
FRAMES, PASSES = 32768, 5
TRAIN_FRAMES = 600
# (dim, g_dtype, pool_mask, passes, frames): phase 5's five, then the training searches'
CONFIGS = ((512, "bf16", None, PASSES, FRAMES), (512, "int8", None, PASSES, FRAMES),
           (512, "bf16", "altparity", PASSES, FRAMES), (256, "bf16", None, PASSES, FRAMES),
           (256, "int8", None, PASSES, FRAMES), (512, "bf16", None, 1, TRAIN_FRAMES),
           (512, "int8", None, 1, TRAIN_FRAMES))
STAGE_CONFIGS = ((512, "bf16"), (512, "int8"), (256, "bf16"))
# auto's two rungs and v1 at the JAX wrapper's defaults
SEQBEAM_BEAMS = tuple(b for b in BEAMS if (b.impl, b.e_dtype, b.M, b.dim, b.R) in (
    ("v2", "int8", 8, 512, 4), ("v2", "bf16", 8, 256, 4), ("v1", "f32", 16, 512, 8)))


def config_name(dim: int, g_dtype: str, pool_mask=None, passes: int = PASSES,
                frames: int = FRAMES) -> str:
    return (f"gramv3_{g_dtype}{'_' + pool_mask if pool_mask else ''}_d{dim}"
            + ("" if (passes, frames) == (PASSES, FRAMES) else f"_p{passes}_b{frames}"))


@torch.no_grad()
def stage_breakdown(problem) -> dict:
    """Where K3's time goes on ``problem``, from its stage-timed build
    (``ops.gramv3.gramv3_stages``), whose indexes must equal the shipped
    kernel's: per stage, its share of the warps' summed cycles and its
    microseconds a frame-step (a warp's cycles in it, over frames x passes
    x nc steps, at the clock rate that the warps' own cycles over their
    nanoseconds give); the timed build's device time beside the shipped
    kernel's; registers and blocks an SM of both."""
    got, stages = K3.gramv3_stages(problem)
    if not torch.equal(got, K3.gramv3_cuda(problem)):
        raise RuntimeError("the stage-timed gramv3's indexes differ from the shipped kernel's")
    st = stages.double().cpu()
    n = len(K3.STAGES)
    cycles = st[:, :n].sum(0)
    share = cycles / cycles.sum()
    ghz = float(st[:, n].sum() / st[:, n + 1].sum())
    steps = problem.xc.shape[0] * problem.passes * problem.gt.shape[0]
    us = cycles / steps / (ghz * 1e3)
    out = {
        "blocks": st.shape[0], "ghz": ghz, "frame_steps": steps,
        "timed_ms": device_ms(lambda: K3.gramv3_stages(problem), 3),
        "kernel_ms": device_ms(lambda: K3.gramv3_cuda(problem), 3),
        "occupancy": K3.gramv3_occupancy(problem),
        "timed_occupancy": K3.gramv3_occupancy(problem, timed=True),
        "share": {k: float(v) for k, v in zip(K3.STAGES, share)},
        "us_per_frame_step": {k: float(v) for k, v in zip(K3.STAGES, us)},
    }
    occ, tocc = out["occupancy"], out["timed_occupancy"]
    out["summary"] = (
        f"{out['blocks']} blocks, {ghz:.3f} GHz, timed {out['timed_ms']:.3f} ms vs "
        f"{out['kernel_ms']:.3f} ms; {occ['registers']} registers, {occ['blocks_per_sm']} "
        f"blocks an SM (timed {tocc['registers']}, {tocc['blocks_per_sm']}): " + ", ".join(
            f"{k} {100 * out['share'][k]:.1f}% {out['us_per_frame_step'][k]:.4f}"
            for k in K3.STAGES) + f", total {float(us.sum()):.4f} us")
    return out


@torch.no_grad()
def precompute_split(qq, x: torch.Tensor, g_dtype: str) -> dict:
    """Device milliseconds of each part of ``gramv3_problem`` on frames
    ``x`` of quantizer ``qq``: the logits-argmax init, the Gram table, XC,
    ``ss0`` and the table's layout, and the whole."""
    from quantization_tpu_torch.core.types import scaled_centers
    from quantization_tpu_torch.ops.beam_common import initial_indexes

    cfg, params = qq.config, qq.params
    nc, D = cfg.num_codebooks, cfg.dim
    centers = scaled_centers(params, cfg.scale_speed).detach().float()
    ctab = centers.reshape(nc * cfg.codebook_size, D).to(torch.bfloat16)
    idx0 = initial_indexes(params, cfg, x)
    gtil, _ = K3.gram_table(ctab, nc, g_dtype)
    return {
        "init_ms": device_ms(lambda: initial_indexes(params, cfg, x), 5),
        "gram_table_ms": device_ms(lambda: K3.gram_table(ctab, nc, g_dtype), 5),
        "xc_ms": device_ms(lambda: K3.cross_terms(x, ctab), 5),
        "ss0_ms": device_ms(lambda: K3.root_scores(centers, idx0, x), 5),
        "layout_ms": device_ms(lambda: K3.table_layout(gtil, nc), 5),
        "total_ms": device_ms(lambda: K3.gramv3_problem(params, cfg, x, passes=PASSES,
                                                        g_dtype=g_dtype), 5),
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gramv3_times needs a CUDA card", file=sys.stderr)
        return 1
    print(f"package {pathlib.Path(qtt.__file__).parent}; {nvidia_smi_line()}", flush=True)
    quantizers = {dim: qtt.load_quantizer(path, device="cuda") for dim, path in TRAINED.items()}
    frames = {dim: make_mlp_sampler(dim, device="cuda")(torch.Generator().manual_seed(9), FRAMES)
              for dim in TRAINED}
    for dim, g_dtype, pool_mask, passes, n in CONFIGS:
        qq, x = quantizers[dim], frames[dim][:n]
        kw = dict(passes=passes, g_dtype=g_dtype, pool_mask=pool_mask)
        problem = K3.gramv3_problem(qq.params, qq.config, x, **kw)
        row = {"config": config_name(dim, g_dtype, pool_mask, passes, n),
               "ms": device_ms(lambda: K3.gramv3_cuda(problem), 10),
               "precompute_ms": device_ms(
                   lambda: K3.gramv3_problem(qq.params, qq.config, x, **kw), 5)}
        if "--stages" in argv and (dim, g_dtype) in STAGE_CONFIGS and not pool_mask and n == FRAMES:
            row["stages"] = stage_breakdown(problem)
            row["precompute_split"] = precompute_split(qq, x, g_dtype)
        print(json.dumps(row), flush=True)
    for beam in SEQBEAM_BEAMS:
        print(json.dumps(beam_time(beam)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
