"""What every run shares: the manifest and the files it names, the cell a
run measures, the asset sums, the check on loaded modules, the numbers
compared, and the set-up clock."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level module names that no run may hold once its window has closed:
# the JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "quantization_tpu")


def read_json(path) -> Any:
    return json.loads(pathlib.Path(path).read_text())


def manifest() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path, name: str):
    """The module in ``path``, imported (once) under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read: the configuration
    (``configs/<config>.json``), the traffic mix (``mixes/<traffic>.json``)
    and the per-layer metrics that list it."""

    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.mix['driver']}.py",
                           f"bench_driver_{self.mix['driver']}")

    def asset(self, key: str) -> pathlib.Path:
        return BENCH / "assets" / self.config[key]


def _lists(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, man: Optional[Dict] = None) -> Cell:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    e2e = [m for m in man["end_to_end"] if _lists(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if _lists(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=w["chips"], config=read_json(ROOT / conf["file"]),
                mix=read_json(BENCH / "mixes" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """``metrics/<base>.py`` of per-layer metric ``<base>.<cells>``."""
    base = name.split(".", 1)[0]
    return load_module(BENCH / "metrics" / f"{base}.py", f"bench_metric_{base}")


def check_assets() -> None:
    """Every asset file matches its sha256 in ``assets/SHA256SUMS``."""
    for line in (BENCH / "assets" / "SHA256SUMS").read_text().splitlines():
        digest, fname = line.split()
        got = hashlib.sha256((BENCH / "assets" / fname).read_bytes()).hexdigest()
        if got != digest:
            raise RuntimeError(f"assets/{fname}: sha256 {got}, expected {digest}")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of ``FORBIDDEN_MODULES``."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class SetupClock:
    """Prints to standard error the seconds each part of set-up took,
    each part ending in a synchronize of the card."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def lap(self, what: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"[setup] {what}: {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now
