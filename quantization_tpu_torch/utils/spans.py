"""Host-side spans of the encode path, kept in memory.

The port's one host-side tracer (``profiling.profile_device_ops`` is the
device-side one).  Each stage of an encode call is wrapped in
``span(name)``; while recording is on, a span keeps its name, its id, the
id of the span open around it on its thread (its parent), the id of the
outermost span open (its call: the spans of one encode call share it), its
thread, its start and end in ``time.time_ns()`` and its attributes.  That
is the host's wall clock, the clock of ``torch.profiler``'s host-side
events (the CUDA runtime calls) within about 10 us on the H100.  The
profiler maps the card's operations onto it once a trace, and that map has
been seen off by up to milliseconds and drifting by hundreds of parts per
million: align the operations through their launch calls' correlation ids
before reading them against the spans (PERF.md section 3).

Usage::

    from quantization_tpu_torch.utils import spans
    spans.start()
    codes = q.encode(x)
    records = spans.stop()  # [SpanRecord(name="quantizer.encode", ...), ...]

Recording is off unless ``start()`` turned it on.  Off, ``span()`` tests
one flag and returns one shared object whose ``with`` does nothing: it
reads no clock and keeps nothing.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class SpanRecord(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]
    call_id: int
    thread_id: int
    start_ns: int
    end_ns: int
    attrs: Dict


_recording = False
_epoch = 0  # bumped by start(): a span opened before it keeps nothing after it
# the closed spans' SpanRecord fields, one after another: a flat list of
# strings, numbers and the few attribute dicts, which leaves the garbage
# collector nothing to count, so a long recording does not trigger it
_records: list = []
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans, innermost last


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "epoch", "span_id", "parent_id", "call_id", "stack",
                 "start_ns")

    def __init__(self, name: str, attrs: Optional[Dict]):
        self.name, self.attrs, self.epoch = name, attrs, _epoch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent else None
        self.call_id = parent.call_id if parent else self.span_id
        self.stack = stack
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self.stack and self.stack[-1] is self:
            self.stack.pop()
        if _recording and self.epoch == _epoch:
            # one call, so atomic against stop() on another thread: a span
            # that closes while stop() runs is either returned or dropped
            _records.extend((self.name, self.span_id, self.parent_id, self.call_id,
                             threading.get_ident(), self.start_ns, end_ns, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add ``attrs`` to the span's attributes (what is known only
        inside its block)."""
        self.attrs = {**(self.attrs or {}), **attrs}


def span(name: str, **attrs):
    """A context manager that records ``name`` over its ``with`` block while
    recording is on, with ``attrs`` and those its ``set(**attrs)`` adds
    inside the block; off, the shared no-op."""
    if not _recording:
        return _OFF
    return _Span(name, attrs or None)  # keeps no empty dict for each span


def start() -> None:
    """Turn recording on; records not yet returned by :func:`stop` are
    dropped."""
    global _recording, _epoch, _records
    _epoch += 1
    _records = []
    _recording = True


def stop() -> List[SpanRecord]:
    """Turn recording off and return the spans closed since :func:`start`,
    in the order they closed; they are not kept."""
    global _recording, _records
    _recording = False
    flat, _records = _records, []
    n = len(SpanRecord._fields)
    return [SpanRecord(*flat[i:i + n - 1], flat[i + n - 1] or {})
            for i in range(0, len(flat), n)]
