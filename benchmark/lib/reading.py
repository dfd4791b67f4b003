"""What a per-layer metric's reader is given: the traced segments, the
cell, the table of peaks and the kernels' counts.

A kernel's count is a module ``counts/<name>.py`` with ``KERNEL``, the
text that names its device operations, and ``work(op_name, call)``: the
operations by type and the bytes that one call's search needs, or None
where it has no count for that instantiation; ``call`` holds the call's
``frames``, ``dim``, ``num_codebooks`` and ``passes``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .common import BENCH, Cell, load_module, read_json
from .trace import Segment


def peaks() -> Dict:
    return read_json(BENCH / "counts" / "peaks.json")


def kernel_counts() -> List:
    return [load_module(p, f"bench_count_{p.stem}")
            for p in sorted((BENCH / "counts").glob("*.py"))]


def least_seconds(work: Dict, pk: Dict) -> float:
    """The least time for ``work``: its bytes at the memory rate or its
    operations at each type's peak rate, whichever is longer."""
    t_bytes = work["bytes"] / pk["bytes_per_s"]
    t_ops = sum(n / pk["ops_per_s"][t] for t, n in work["ops"].items())
    return max(t_bytes, t_ops)


@dataclasses.dataclass
class Reading:
    segments: List[Segment]
    cell: Cell
    peaks: Dict
    counts: List

    def count_for(self, op_name: str):
        """The count module whose kernel this device operation is."""
        for c in self.counts:
            if c.KERNEL in op_name:
                return c
        return None

    def least_seconds(self, work: Dict) -> float:
        return least_seconds(work, self.peaks)

    def search_ops(self, seg: Segment):
        return [(n, s, e) for n, s, e in seg.ops if self.count_for(n) is not None]

    def sum(self, key: str) -> float:
        return sum(g.info.get(key, 0) for g in self.segments)

    @property
    def wall_s(self) -> float:
        return sum(g.wall_s for g in self.segments)


def make(segments: List[Segment], cell: Cell) -> Optional[Reading]:
    return Reading(segments, cell, peaks(), kernel_counts()) if segments else None
