"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the program's kernels, the assets, the frames
drawn from the seed, the warm-up of the cell's shapes) is ``setup_s``.
Then the cell's driver (``drivers/<mix's driver>.py``) runs its traffic
(``mixes/<traffic>.json``) on its configuration (``configs/<config>.json``)
for ``--seconds``, and the plain reference judges what the window
produced.  With ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` the profiler covers a steady stretch of the
window and the result holds the per-layer metrics, each read by
``metrics/<base name>.py``.  The last line on standard output is the
result as one JSON object; the numbers compared, each with its limit, are
the last lines on standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Every kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of ``cell`` on ``device``: the result's fields, before the
    check on loaded modules."""
    import torch

    from benchmark.lib import reading
    from benchmark.lib.common import Check, metric_reader
    from benchmark.lib.trace import Tracer, breakdown, busy_s, window_s

    device = torch.device(device)
    cuda = device.type == "cuda"
    drv = cell.driver
    tracer = Tracer(trace)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    st = drv.setup(cell, seed, device, tracer)
    setup_s = time.perf_counter() - t0
    out = drv.window(st, seconds)
    tracer.finish()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    limits = {**cell.config.get("limits", {}), **cell.mix.get("limits", {})}
    judged = drv.check(st, limits)
    checks = [Check(*c) for c in judged["checks"]]
    values = {"setup_s": setup_s, **out["metrics"]}
    metrics = {}
    if trace:
        r = reading.make(tracer.segments, cell)
        for m in cell.per_layer:
            v = None if r is None else metric_reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:  # metric <base>.<cells> reports the loop's <base>
            base = m["name"].split(".", 1)[0]
            if base in values:
                metrics[m["name"]] = {"value": values[base], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks), "attempted": out["attempted"],
              "failed": judged["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = busy_s(tracer.segments)
        dev["window_s"] = window_s(tracer.segments)
        result["breakdown"] = breakdown(tracer.segments)
    result["detail"] = judged.get("detail", {})
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib.common import check_assets, find_cell, forbidden_modules

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    check_assets()
    print(f"[setup] imports and the card: {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr, flush=True)
    card = card_line()
    print(f"[card] {card}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
