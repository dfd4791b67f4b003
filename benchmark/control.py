"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's sound runs, the control, and each planted
fault, one JSON line a reading, in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \\
        [--seconds 3] [--modes program,control,stale,half,altered,...]

Encode cells: each reading is a set-up from the seed, a short window at
the cell's own load and the run's check.  ``control``: the plain
reference put in the program's place, cut to one beam pass (the step
that would tempt a later change: a pass is a third of the search);
``bf16``, ``tf32``, ``int8`` and ``int4``: the reference's five passes
with every inner product's operands at that precision, for the record
(the beam's choices barely move with the precision, see PERF.md).
``stale``, ``half`` and ``altered`` plant the faults of ``lib/faults.py``
in the program.  The benchmark's own runs never run
this."""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cast(kind: str):
    import torch

    if kind == "bf16":
        return lambda t: t.to(torch.bfloat16).float()
    if kind in ("int8", "int4"):
        lim = 127 if kind == "int8" else 7

        def q(t):
            s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / lim
            return torch.round(t / s).clamp(-lim, lim) * s

        return q
    return None


def reference_encoder(p, conf, passes: int, cast, allow_tf32: bool = False):
    """The plain reference in the program's place: codes of ``passes``
    beam passes, in blocks."""
    import torch

    from benchmark.reference import quantizer as R

    def encode(x):
        idx = torch.cat([R.encode_indexes(p, x[s:s + 4096], passes, cast, allow_tf32=allow_tf32)
                         for s in range(0, x.shape[0], 4096)])
        return R.pack(idx, conf["codebook_size"])

    return encode


def read_encode(cell, seed, mode, seconds, device):
    from benchmark.lib.faults import FAULTS, encode_fault
    from benchmark.lib.trace import Tracer
    from benchmark.reference import quantizer as R

    drv = cell.driver
    limits = {**cell.config.get("limits", {}), **cell.mix.get("limits", {})}
    fault = encode_fault(mode) if mode in FAULTS else contextlib.nullcontext()
    with fault:
        st = drv.setup(cell, seed, device, Tracer(False))
        if mode not in FAULTS and mode != "program":
            p = R.load(cell.asset("quantizer"), device)
            passes = 1 if mode == "control" else 5
            st.encode = reference_encoder(p, cell.config, passes, _cast(mode),
                                          allow_tf32=mode == "tf32")
        drv.window(st, seconds)
        return drv.check(st, limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--modes", default="program,control,stale,half,altered")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib.common import find_cell

    cell = find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = {}
    for mode in args.modes.split(","):
        for seed in seeds:
            t0 = time.perf_counter()
            out = read_encode(cell, seed, mode, args.seconds, args.device)
            line = {"workload": cell.name, "mode": mode, "seed": seed,
                    "checks": {n: v for n, v, _ in out["checks"]},
                    "rel_err": out["detail"].get("rel_err"),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            for n, v, _ in out["checks"]:
                readings.setdefault(mode, {}).setdefault(n, []).append(v)
    summary = {m: {n: {"min": min(v), "max": max(v)} for n, v in r.items()}
               for m, r in readings.items()}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
