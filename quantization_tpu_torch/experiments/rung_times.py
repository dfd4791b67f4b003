"""End-to-end encode times of auto's candidate rungs, on the card.

For each trained quantizer (d512 / 8 B, d256 / 4 B, d1280 / 8 B), each
call size (by default 8,192 frames: the CLI's batch; 512: a predictor's
minibatch) and each rung (auto's first seqbeam rung, and every Gram-table
candidate of ``ops/quality_guard.py``; ``--rungs`` keeps those whose names
hold one of its words), this times whole ``Quantizer.encode`` calls in a
closed loop, as a caller sees them: each call is followed by a
synchronize, and its milliseconds are the host's clock from before the
call to after the synchronize.  The rungs run in turns, ``--rounds``
rounds of ``--seconds`` each, so that a drift of the card or the host
falls on every rung alike; the line of a rung gives the median call over
all rounds and each round's median.

    python -m quantization_tpu_torch.experiments.rung_times [--configs 512x8 1280x16]
        [--sizes 8192 512] [--rungs seqbeam bf16_alt3] [--rounds 3] [--seconds 0.4]
        [--out chiprun_out/rung_times.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import time

import torch

from quantization_tpu_torch.data.synthetic import make_mlp_sampler
from quantization_tpu_torch.ops import ladder
from quantization_tpu_torch.ops.quality_guard import GRAMV3_CANDIDATES, TRAINED
from quantization_tpu_torch.ops.seqbeam import SEQBEAM
from quantization_tpu_torch.utils.device import nvidia_smi_line
from quantization_tpu_torch.utils.serialization import load_quantizer

SIZES = (8192, 512)


def rungs(config, words=None) -> list:
    """The rung records timed for ``config``: auto's first seqbeam rung
    (where its ladder has one), then the gramv3 candidates; only those whose
    names hold one of ``words``, where given."""
    out = [*[r for r in ladder.rungs(config) if r.kernel is SEQBEAM][:1],
           *GRAMV3_CANDIDATES[(config.dim, config.num_codebooks)]]
    return [r for r in out if not words or any(w in r.name for w in words)]


def call_ms(encode, seconds: float) -> list:
    """Milliseconds of each closed-loop call of ``encode`` over about
    ``seconds``."""
    out, end = [], time.perf_counter() + seconds
    while time.perf_counter() < end or len(out) < 5:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@torch.no_grad()
def time_config(key: tuple, sizes, words, rounds: int, seconds: float) -> list:
    """The rungs' call times for the trained quantizer ``TRAINED[key]``,
    ``key`` its (dim, num_codebooks)."""
    dim = key[0]
    q = load_quantizer(TRAINED[key], device="cuda")
    sampler = make_mlp_sampler(dim, device="cuda")
    results = []
    for n in sizes:
        x = sampler(torch.Generator().manual_seed(11), n)
        calls = {}
        for rung in rungs(q.config, words):
            def encode(rung=rung):
                return q.encode(x, search_method=rung.kernel.name,
                                refine_indexes_iters=rung.passes, **rung.kwargs())
            for _ in range(3):  # builds, tables, allocator
                encode()
            calls[rung.name] = (encode, [])
        torch.cuda.synchronize()
        for _ in range(rounds):
            for name, (encode, got) in calls.items():
                got.append(call_ms(encode, seconds))
        for rung in rungs(q.config, words):
            got = calls[rung.name][1]
            entry = {"dim": dim, "frames": n, "rung": rung.name, "passes": rung.passes,
                     "median_ms": statistics.median(v for r in got for v in r),
                     "round_medians_ms": [statistics.median(r) for r in got],
                     "calls": sum(len(r) for r in got)}
            results.append(entry)
            print(f"[rung d{dim} B={n}] {rung.name:24s} {entry['median_ms']:.4f} ms a call "
                  f"(rounds {', '.join(f'{v:.4f}' for v in entry['round_medians_ms'])}; "
                  f"{entry['calls']} calls)", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=[f"{d}x{n}" for d, n in TRAINED],
                    metavar="DIMxNC", help="trained quantizers by dim and codebooks")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--rungs", nargs="+", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.4)
    ap.add_argument("--out", type=pathlib.Path, default=pathlib.Path("chiprun_out/rung_times.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rung_times times the encode on a CUDA card; none is available")
    card = nvidia_smi_line()
    print(card, flush=True)
    keys = [tuple(int(v) for v in c.split("x")) for c in args.configs]
    results = [e for key in keys
               for e in time_config(key, args.sizes, args.rungs, args.rounds, args.seconds)]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "results": results}, indent=1) + "\n")


if __name__ == "__main__":
    main()
