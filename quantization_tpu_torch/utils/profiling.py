"""Device-op profiling.

PyTorch counterpart of ``quantization_tpu/utils/profiling.py``: run a
callable under ``torch.profiler`` and digest the trace into a table of
device time by kernel, the same rows as the JAX function's.

Usage::

    from quantization_tpu_torch.utils.profiling import profile_device_ops
    table = profile_device_ops(lambda: q.encode(x))
    for row in table[:10]:
        print(row)  # {'source': ..., 'ms': ..., 'count': ...}
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Callable, Dict, List

import torch
from torch.profiler import ProfilerActivity

from ..core.types import resolve_device

logger = logging.getLogger(__name__)


# traced windows tried on the card before a call is taken to have launched
# nothing: the tracer (torch.profiler on CUPTI) now and then returns a window
# without any device activity, even for a call that launched hundreds of
# kernels (about one window in 40 on an H100), and the next window of the
# same call holds them
TRACE_ATTEMPTS = 3


def profile_device_ops(run: Callable[[], object], trace_dir: str | None = None,
                       device=None) -> List[Dict]:
    """Run ``run()`` under ``torch.profiler`` and return its operations'
    time by name, ``{"source", "ms", "count"}`` rows sorted by total
    milliseconds, descending.

    ``run`` is called twice: once to warm up, untraced, and once traced (a
    tracer started cold has been seen to miss the first kernel of its
    window).  Each call ends in a synchronize of the card.  On the card, a
    traced call that shows no device activity is traced again (a warm-up
    and a traced call each time), up to ``TRACE_ATTEMPTS`` times, with a
    warning each time; after the last, the empty table is returned.

    On ``device`` (default: the GPU) a row is one CUDA device activity (a
    kernel, copy or fill), keyed by its name, with its device time; the
    rows do not overlap on one stream, so their sum is the time the card
    was busy.  With ``device="cpu"`` a row is one CPU operator with its own
    (self) time, the counterpart of the JAX function's CPU fallback.  With
    ``trace_dir``, the traced call's Chrome trace is written there as
    ``trace.json``."""
    device = resolve_device(device)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        agg, cnt = _trace(run, device, trace_dir)
        if agg or device.type != "cuda" or attempt == TRACE_ATTEMPTS:
            break
        logger.warning("the traced call showed no device activity; tracing it again "
                       "(attempt %d of %d)", attempt + 1, TRACE_ATTEMPTS)
    return [
        {"source": k, "ms": round(v / 1000.0, 3), "count": cnt[k]}
        for k, v in agg.most_common()
    ]


def _trace(run: Callable[[], object], device: torch.device, trace_dir: str | None):
    """One warm-up call and one traced call of ``run``: the traced call's
    microseconds and counts by name."""
    cuda = device.type == "cuda"
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()

    def digest(prof) -> None:
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        if cuda:
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    agg[ev.name] += ev.time_range.elapsed_us()
                    cnt[ev.name] += 1
        else:
            for ev in prof.key_averages():
                if not ev.key.startswith("ProfilerStep"):  # the schedule's own span
                    agg[ev.key] += ev.self_cpu_time_total
                    cnt[ev.key] += ev.count

    # on the card only its own activities are traced, so that the tracer adds
    # little host time to the call it measures
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities,
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                on_trace_ready=digest) as prof:
        for _ in range(2):
            run()
            if cuda:
                torch.cuda.synchronize(device)
            prof.step()
    return agg, cnt
