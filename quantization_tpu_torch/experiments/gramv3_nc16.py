"""K3 at 16 codebooks on the card, on seeded codebooks and frames at dim
1280: every index against the plain version (bf16 and int8 tables; B 1,
63, 8,192 and 8,193), then at 8,192 frames the kernel's device time at
auto's beam (M=8, R=4, altparity) for 3, 4 and 5 passes beside its bound
(and the plain version's at 3), its registers, blocks an SM and shared
memory, the stage-timed build's breakdown, and ptxas's report of every
instantiation.  The log lines print each beside the figures of the build
that staged the step's shared rows at 16 codebooks in bf16 too
(``STAGED``, committed); the returned dict holds only what this run
measured.  Needs a CUDA card.

    python -m quantization_tpu_torch.experiments.gramv3_nc16 [--out FILE]

Run as a file, it takes ``quantization_tpu_torch`` from ``PYTHONPATH``, so
another checkout's kernel (one with ``ops.gramv3.rows_path``) is measured
on the same problems in the same run:

    PYTHONPATH=<checkout> python quantization_tpu_torch/experiments/gramv3_nc16.py
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re

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
# the kernel as built when bf16 at 16 codebooks staged its shared rows (as
# f32 in 60 KB of dynamic shared memory, 3 blocks an SM), on the H100 at
# 700 W: ptxas of every instantiation, the stage split and the times here;
# printed beside this run's figures, never compared to raise
STAGED = pathlib.Path(__file__).with_name("gramv3_staged_build.json")
_ENTRY = re.compile(r"gramv3_kernelILb(\d)ELi(\d+)ELi(\d+)ELb(\d)E")


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("chiprun_out/gramv3_nc16.json"))
    args = ap.parse_args(argv)
    out = report(log=lambda line: print(line, flush=True))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1) + "\n")


def ptxas_table(log: str) -> dict:
    """ptxas's report of each kernel instantiation in a ``-Xptxas -v`` log,
    keyed ``gramv3_kernel<I8, NC, M, TIMED>``: its codebooks, registers,
    static shared memory, stack frame and spill bytes."""
    table, key = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if "Compiling entry" in line and m:
            i8, nc, M, timed = m.groups()
            key = (f"gramv3_kernel<{'true' if i8 == '1' else 'false'}, {nc}, {M}, "
                   f"{'true' if timed == '1' else 'false'}>")
            table[key] = {"nc": int(nc)}
        elif key is not None:
            for name, pat in (("stack", r"(\d+) bytes stack frame"),
                              ("spill_stores", r"(\d+) bytes spill stores"),
                              ("spill_loads", r"(\d+) bytes spill loads"),
                              ("registers", r"Used (\d+) registers"),
                              ("smem", r"(\d+) bytes smem")):
                found = re.search(pat, line)
                if found:
                    table[key][name] = int(found.group(1))
            if "Used" in line and "registers" in line:
                table[key].setdefault("smem", 0)
                key = None
    return table


@torch.no_grad()
def report(checks: bool = True, log=print) -> dict:
    """Everything the module measures, each line passed to ``log`` beside
    the staged build's figures; returns only this run's numbers, with
    ``check_launches`` the kernel's launches in the checks alone.  Raises
    RuntimeError where an index differs from the plain version's."""
    from quantization_tpu_torch.experiments.gramv3_times import stage_breakdown

    out = {"card": nvidia_smi_line(), "package": K3.__file__, "checks": [], "times": []}
    log(out["card"])
    out["build_s"] = cuda_build.build(["gramv3", "logits_argmax"])
    log(f"[gramv3 nc16 build] {out['build_s']:.1f} s")
    params, config, x_all = seeded(max(CHECK_SIZES), "cuda")
    K3.GRAMV3_KERNEL.launches = 0
    for g in ("bf16", "int8") if checks else ():
        for B in CHECK_SIZES:
            p = K3.gramv3_problem(params, config, x_all[:B], passes=3, g_dtype=g, **BEAM)
            got, want = K3.gramv3_cuda(p), K3.gramv3_plain(p)
            eq = float((got == want).float().mean())
            out["checks"].append({"g_dtype": g, "B": B, "index_agreement": eq,
                                  "equal": bool(torch.equal(got, want))})
            log(f"[gramv3 nc16 check {g} B={B}] indexes equal to plain: {torch.equal(got, want)} "
                f"(agreement {eq:.6f})")
            if not torch.equal(got, want):
                raise RuntimeError(f"K3 at 16 codebooks, {g}, B={B}: indexes differ from plain")
    out["check_launches"] = K3.GRAMV3_KERNEL.launches
    staged = json.loads(STAGED.read_text())
    x = x_all[:TIME_B]
    for g in ("bf16", "int8"):
        for passes in (3, 4, 5):
            p = K3.gramv3_problem(params, config, x, passes=passes, g_dtype=g, **BEAM)
            ms = device_ms(lambda: K3.gramv3_cuda(p), 10)
            b = bound_ms(TIME_B, passes, BEAM["M"], g)
            occ = K3.gramv3_occupancy(p)
            entry = {"g_dtype": g, "passes": passes, "B": TIME_B, "ms": ms, "bound_ms": b,
                     "roofline_pct": 100.0 * b / ms, "rows": K3.rows_path(g, NC), **occ}
            if passes == 3:
                entry["plain_ms"] = device_ms(lambda: K3.gramv3_plain(p), 2)
            out["times"].append(entry)
            log(f"[gramv3 nc16 time {g} passes={passes}] {ms:.4f} ms (rows {entry['rows']}; "
                f"staged build {staged['ms'][g][str(passes)]:.4f}), bound {b:.4f} ms "
                f"({100 * b / ms:.1f}%); {occ['registers']} registers, "
                f"{occ['blocks_per_sm']} blocks an SM, {occ['smem_bytes']} bytes of shared "
                "memory a block" + (f"; plain {entry['plain_ms']:.3f} ms" if passes == 3 else ""))
    p = K3.gramv3_problem(params, config, x, passes=3, g_dtype="bf16", **BEAM)
    out["stages_bf16"] = stage_breakdown(p)
    log(f"[gramv3 stages nc16 bf16 passes=3] load {100 * out['stages_bf16']['share']['load']:.1f}% "
        f"of the warps' cycles (staged build {100 * staged['stages_bf16_passes3']['load']:.1f}%; "
        "the timed build's clock reads make each load group land, so at 16 codebooks its split "
        f"does not track the untimed kernel's time): {out['stages_bf16']['summary']}")
    out["ptxas"] = ptxas_table(cuda_build.build_log("gramv3"))
    if not out["ptxas"]:
        log("[gramv3 ptxas] no ptxas report: the library came from the build cache")
    else:
        low = lambda table: {k: v for k, v in table.items() if v["nc"] <= 8}
        log("[gramv3 ptxas] the instantiations up to 8 codebooks as the staged build's: "
            f"{low(out['ptxas']) == low(staged['ptxas'])}")
    for k in sorted(set(staged["ptxas"]) | set(out["ptxas"])):
        now, was = out["ptxas"].get(k), staged["ptxas"].get(k)
        log(f"[gramv3 ptxas {k}] {now} (staged build {was})"
            + ("" if now is None or was is None else f"; equal: {now == was}"))
    return out


if __name__ == "__main__":
    main()
