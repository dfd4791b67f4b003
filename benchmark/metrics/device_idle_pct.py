"""The share of the traced stretches in which no operation ran on the
card: 1 - (the union of the device operations' intervals) / (the
stretches' wall time)."""

from benchmark.lib.trace import busy_s, window_s


def read(r):
    wall = window_s(r.segments)
    return 100.0 * (1.0 - busy_s(r.segments) / wall) if wall > 0 else None
