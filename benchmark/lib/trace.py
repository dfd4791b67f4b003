"""The traced run's reading of the card.

A traffic loop (``drivers/``) opens the profiler around a steady stretch
of its window (``begin``/``end``), and marks its own calls into each
layer with ``span(name)``: the host's spans, by which the device's idle
gaps are labelled.  The stretch is digested into a
:class:`Segment`: the device's operations with their times, the host's
spans, and the stretch's own bounds, in seconds from the stretch's start.
The busy time is the union of the device's operation intervals, so
operations that overlap count once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

ATTEMPTS = 3  # stretches tried before a run gives up on a trace with no device time

Interval = Tuple[float, float]  # seconds on the profiler's clock


@dataclasses.dataclass
class Segment:
    """One traced stretch: [start, end] in seconds, the device's
    operations as (name, start, end), the host's spans as (name, start,
    end), and what the loop did in it (``info``: calls, frames, steps)."""

    start: float
    end: float
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    info: Dict

    @property
    def wall_s(self) -> float:
        return self.end - self.start


def union_length(intervals: List[Interval], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def host_timeline(spans: List[Tuple[str, float, float]], lo: float,
                  hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi] cut at every span's ends, each piece labelled by the
    innermost (shortest) host span open over it, or ``"between spans"``."""
    cuts = sorted({lo, hi} | {t for _, s, e in spans for t in (s, e) if lo < t < hi})
    starts = sorted(spans, key=lambda sp: sp[1])
    out, active, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(starts) and starts[i][1] <= a:
            active.append(starts[i])
            i += 1
        active = [sp for sp in active if sp[2] > a]
        inner = min(active, key=lambda sp: sp[2] - sp[1], default=None)
        out.append((a, b, inner[0] if inner else "between spans"))
    return out


def busy_s(segments: List[Segment]) -> float:
    return sum(union_length([(s, e) for _, s, e in g.ops], g.start, g.end) for g in segments)


def window_s(segments: List[Segment]) -> float:
    return sum(g.wall_s for g in segments)


def breakdown(segments: List[Segment], top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, summed over the segments: at most ``top``
    entries each, as [name, seconds]."""
    ops: collections.Counter = collections.Counter()
    idle: collections.Counter = collections.Counter()
    for g in segments:
        for name, s, e in g.ops:
            ops[name[:120]] += e - s
        pieces = host_timeline(g.spans, g.start, g.end)
        k = 0
        for s, e in idle_gaps([(s, e) for _, s, e in g.ops], g.start, g.end):
            while k < len(pieces) and pieces[k][1] <= s:
                k += 1
            j = k
            while j < len(pieces) and pieces[j][0] < e:
                a, b, name = pieces[j]
                idle[name] += min(b, e) - max(a, s)
                j += 1
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}


def digest(events, t0_ns: int, t1_ns: int, spans, info: Dict) -> Segment:
    """A :class:`Segment` from the profiler's raw events
    (``prof.profiler.kineto_results.events()``), whose clock is the host's
    wall clock (``time.time_ns``), and the host's spans on that clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = [(ev.name(), (ev.start_ns() - t0_ns) * 1e-9, (ev.end_ns() - t0_ns) * 1e-9)
           for ev in events if ev.device_type() == cuda and not ev.is_user_annotation()]
    spans = [(n, (s - t0_ns) * 1e-9, (e - t0_ns) * 1e-9) for n, s, e in spans]
    return Segment(0.0, (t1_ns - t0_ns) * 1e-9, ops, spans, dict(info))


class _Span:
    __slots__ = ("log", "name", "start")

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.start = time.time_ns()

    def __exit__(self, *exc):
        self.log.append((self.name, self.start, time.time_ns()))


class Tracer:
    """Profiles the stretch a traffic loop asks for; off, it costs nothing.

    The profiler records the card's activity alone (CUDA, not the host's
    operators), so that it adds little host time to what it measures; the
    host's spans are the loop's own, read from the host's wall clock,
    the clock of the profiler's events.  ``begin`` starts a stretch and
    ``end(info)`` closes it; a stretch that shows no device operation (the
    tracer now and then returns one) is dropped, and ``wanted`` stays true
    so that the loop traces another, up to ``ATTEMPTS`` tries.  The
    stretch is digested by ``finish``, after the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.kept: List[tuple] = []
        self.segments: List[Segment] = []
        self.tries = 0
        self._prof = None
        self._spans: List[tuple] = []
        self._t0 = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def wanted(self) -> bool:
        return self.enabled and not self.kept and self.tries < ATTEMPTS

    def span(self, name: str):
        return _Span(self._spans, name) if self._prof is not None else contextlib.nullcontext()

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._spans = []
        self._t0 = time.time_ns()

    def end(self, info: Dict) -> bool:
        """Close the stretch; True if it is kept."""
        import torch

        torch.cuda.synchronize()
        t1 = time.time_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.tries += 1
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        if not any(ev.device_type() == cuda for ev in events):
            return False
        self.kept.append((events, self._t0, t1, self._spans, dict(info)))
        return True

    def finish(self) -> List[Segment]:
        self.segments = [digest(*k) for k in self.kept]
        self.kept = []
        return self.segments
