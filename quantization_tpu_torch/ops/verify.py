"""The GPU tables behind ``search_method="auto"``.

``verified.json`` (smoke entries) and ``quality.json`` (measured quality
deltas vs the exact beam-5) beside this module are written on an H100 by
``python -m quantization_tpu_torch.ops.quality_guard``; each entry records
the card it was measured on.  They hold GPU runs only: the JAX package's
tables record TPU runs and do not carry over.

The table is advisory-negative: a config marked ``ok: false``, or missing
(e.g. a checkout without the file), is never auto-selected; an explicit
``search_method=`` always bypasses the gate.
"""

from __future__ import annotations

import functools
import json
import pathlib

VERIFIED = pathlib.Path(__file__).with_name("verified.json")
QUALITY = pathlib.Path(__file__).with_name("quality.json")


@functools.lru_cache(maxsize=None)
def _read(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        return {}


def kernel_verified(name: str) -> bool:
    """True iff the named config passed its smoke check on the GPU."""
    entry = _read(VERIFIED).get("results", {}).get(name)
    return bool(entry and entry.get("ok"))


def quality_delta_pct(name: str):
    """Worst measured relative reconstruction error delta (percent vs the
    exact beam-5 search, max over eval seeds) of the named config, or None
    when the config has no measurement."""
    entry = _read(QUALITY).get("results", {}).get(name)
    if not entry:
        return None
    return entry.get("max_delta_pct")


def train_ratio_vs_torch() -> float:
    """Relative reconstruction loss ratio of the shipped trained quantizer
    vs the torch reference trainer (1.000109,
    experiments/head_to_head_d512_b8_10000+10000.json) — a property of the
    trained artifact, not of a chip.  1.0 when unrecorded."""
    return float(_read(QUALITY).get("train_ratio_vs_torch", 1.0))


def combined_margin_pct(name: str):
    """Combined margin vs the torch reference, percent: (train ratio x
    worst-seed encode delta) - 1.  None when the config has no encode
    measurement."""
    delta = quality_delta_pct(name)
    if delta is None:
        return None
    return (train_ratio_vs_torch() * (1.0 + delta / 100.0) - 1.0) * 100.0
