"""Closed-loop encode: one caller sends ``Quantizer.encode(x)`` with the
program's defaults (``search_method="auto"``, 5 refinement iterations) and
waits for the codes (a synchronize of the card) before its next call.

A call's latency is read from two CUDA events on the card's stream, one
recorded before the call and one after it, so it spans the host's
launches and the device's work by the device's clock; the window's
length and its rate are the host's.

The mix gives the call sizes as a list.  Every seed sends the same sizes;
the seed orders them, one permutation a cycle.  The frames come from a pool of ``pool_frames``
frames drawn on the card from the seed; a call takes the next ``size``
frames of the pool, from its start again when they run out.

The codes of ``sample_calls`` calls, drawn from the seed over all calls
of the window (a reservoir sample), are judged after the window against
the plain reference: the exact beam-5 on the same frames.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, List, Optional

import torch

from benchmark.lib.common import SetupClock, percentile
from benchmark.lib.sampler import MlpSampler, generator
from benchmark.lib.trace import Tracer
from benchmark.reference import quantizer as R

BLOCK = 4096  # frames a block of the reference
MARK_S = 5.0  # the window's calls are also counted every MARK_S seconds


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    tracer: Tracer
    encode: Callable[[torch.Tensor], torch.Tensor]
    pool: torch.Tensor
    sizes: List[int]
    order_rng: random.Random
    choice: Optional[tuple]
    sample: Optional[Reservoir] = None
    calls: int = 0
    frames: int = 0
    elapsed: float = 0.0
    marks: List[int] = dataclasses.field(default_factory=list)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CallTimer:
    """Seconds from ``start`` to ``stop``, after the synchronize that ends
    the call: by CUDA events on the card, by the host's clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self.cuda:
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.ev[1].record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            return self.ev[0].elapsed_time(self.ev[1]) * 1e-3
        return self.t1 - self.t0


def setup(cell, seed: int, device, tracer: Tracer) -> State:
    import quantization_tpu_torch as qtt
    from quantization_tpu_torch.core.codec import auto_choice

    device = torch.device(device)
    mix, conf = cell.mix, cell.config
    clock = SetupClock(device)
    q = qtt.load_quantizer(cell.asset("quantizer"), device=device)
    sampler = MlpSampler(cell.asset("sampler"), conf["dim"], device)
    pool = sampler.draw(generator(device, seed, 0), mix["pool_frames"])
    clock.lap("quantizer and frames")
    sizes = [int(s) for s in mix["sizes"]]
    st = State(cell=cell, seed=seed, device=device, tracer=tracer,
               encode=lambda x: q.encode(x), pool=pool, sizes=sizes,
               order_rng=random.Random(seed), choice=auto_choice(q.config, pool[:1], 5))
    st.encode(pool[:sizes[0]])
    clock.lap("first call (builds the kernels where the checkout has none)")
    for n in sorted(set(sizes)):  # the shapes this traffic sends, and no other
        for _ in range(mix.get("warm_calls", 2)):
            st.encode(pool[:n])
    clock.lap("warm calls")
    return st


def _schedule(st: State):
    while True:
        order = list(st.sizes)
        st.order_rng.shuffle(order)
        yield from order


def window(st: State, seconds: float) -> dict:
    mix, tracer, dev = st.cell.mix, st.tracer, st.device
    trace = mix["trace"]
    st.sample = Reservoir(mix["sample_calls"], random.Random(st.seed + 1))
    lat, offset, seg = [], 0, None
    timer = CallTimer(dev)
    sizes = _schedule(st)
    t_start = time.perf_counter()
    while True:
        n = next(sizes)
        if tracer.wanted and not tracer.active and st.calls >= trace["start"]:
            tracer.begin()
            seg = {"calls": 0, "frames": 0, "sizes": []}
        with tracer.span("draw"):
            if offset + n > st.pool.shape[0]:
                offset = 0
            x = st.pool[offset:offset + n]
        timer.start()
        with tracer.span("encode_call"):
            codes = st.encode(x)
        timer.stop()
        with tracer.span("synchronize"):
            sync(dev)
        t1 = time.perf_counter()
        lat.append(timer.seconds())
        st.sample.offer((offset, n, codes))
        offset += n
        st.calls += 1
        st.frames += n
        if tracer.active:
            seg["calls"] += 1
            seg["frames"] += n
            seg["sizes"].append(n)
            if seg["calls"] == trace["calls"]:
                tracer.end(dict(seg, choice=st.choice))
        if t1 - t_start >= (len(st.marks) + 1) * MARK_S:
            st.marks.append(st.calls)
        if t1 - t_start >= seconds:
            break
    if tracer.active:
        tracer.end(dict(seg, choice=st.choice))
    st.elapsed = time.perf_counter() - t_start
    return {"metrics": {"encode_vps": st.frames / st.elapsed,
                        "encode_p95_ms": percentile(lat, 95) * 1e3},
            "attempted": st.calls}


def check(st: State, limits: dict) -> dict:
    """The sampled calls' codes against the exact beam-5 of the plain
    reference on the same frames: the excess of their squared error in
    percent (``delta_pct``), and the calls whose codes are not (n, bytes)
    uint8 (``malformed_calls``).  ``rel_err``, their relative error, is
    reported beside them."""
    conf = st.cell.config
    st.encode = None  # the program's quantizer goes before the reference runs
    p = R.load(st.cell.asset("quantizer"), st.device)
    nc, cs = conf["num_codebooks"], conf["codebook_size"]
    sse_prog = sse_ref = spread = 0.0
    malformed = 0
    for offset, n, codes in st.sample.items:
        if (tuple(codes.shape) != (n, conf["bytes_per_frame"]) or codes.dtype != torch.uint8):
            malformed += 1
            continue
        idx = R.unpack(codes, cs, nc)
        for s in range(0, n, BLOCK):
            x = st.pool[offset + s:offset + min(n, s + BLOCK)]
            sse_prog += float(R.frame_sse(p, x, idx[s:s + BLOCK]).sum())
            sse_ref += float(R.frame_sse(p, x, R.encode_indexes(p, x, passes=5)).sum())
            spread += float(R.spread_sumsq(p, x))
    delta = 100.0 * (sse_prog / sse_ref - 1.0) if sse_ref > 0 else math.inf
    return {"checks": [("delta_pct", delta, limits["delta_pct"]),
                       ("malformed_calls", float(malformed), 0.0)],
            "failed": malformed,
            "detail": {"calls_by_mark": st.marks,
                       "rel_err": sse_prog / spread if spread > 0 else math.inf}}
