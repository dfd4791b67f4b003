"""The probes' times on two checkouts of the repository, in turns on one card.

Each run is a fresh process started in a checkout's root, which times that
checkout's kernels at the JAX scripts' shapes: P1-P4 in ms an iteration (the
slope of ``experiments/prim_bench.py``), P5 and P6 in ms a chain (the mean of
50 chains by ``device_ms``).  A round runs the other checkout, this one, this
one, the other; the medians over the rounds are compared per probe.

Run on the card, with another checkout unpacked under a directory that
``.gitignore`` lists (``git archive <commit> | tar -x -C _checkout/parent``):

    python -m quantization_tpu_torch.experiments.probe_turns --other _checkout/parent
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# what a run executes in a checkout's root: only names that every checkout
# since the probes were ported has
RUN = """
import json, torch
from quantization_tpu_torch.experiments import int8_mxu_probe as P56
from quantization_tpu_torch.experiments import prim_bench as P14
from quantization_tpu_torch.utils.device import device_ms
dev = torch.device("cuda")
out = {p.name: P14.slope_us(p.run, *p.Ks) * 1e-3 for p in P14.probes(dev)}
out.update({ch.name: device_ms(ch.run, 50) for ch in P56.chains(dev)})
print("RESULT " + json.dumps(out), flush=True)
"""


def run_in(tree: pathlib.Path) -> dict:
    """One fresh process in ``tree``'s root: each probe's ms."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    done = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"the probes failed in {tree}:\n{done.stdout[-2000:]}"
                           f"\n{done.stderr[-4000:]}")
    line = next(l for l in done.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/probe_turns.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_turns: no CUDA device is available; the probes run only on a card",
              file=sys.stderr)
        return 2
    from ..utils.device import nvidia_smi_line

    trees = {"other": pathlib.Path(args.other).resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for r in range(args.rounds):
        for who in ("other", "this", "this", "other"):
            runs[who].append(run_in(trees[who]))
            print(f"round {r} {who}: " + json.dumps(runs[who][-1]), flush=True)
    names = list(runs["this"][0])
    med = {who: {n: statistics.median(x[n] for x in runs[who]) for n in names} for who in runs}
    for n in names:
        print(f"{n}: other {med['other'][n]:.6g} ms, this {med['this'][n]:.6g} ms, "
              f"this / other {med['this'][n] / med['other'][n]:.4f}", flush=True)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "trees": {k: str(v) for k, v in trees.items()},
                               "median_ms": med, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
