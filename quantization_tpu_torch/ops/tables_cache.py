"""The cache of a kernel's tables, made from the parameters alone: the two
search kernels' (``ops/seqbeam.py``, ``ops/gramv3.py``) and the initial
indexes' split weights (``ops/logits_argmax.py``)."""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Callable, Optional, Tuple

import torch

from ..core.types import QuantizerParams, scaled_centers
from ..utils.spans import span

CENTERS = ("centers", "centers_scale")


def centers_input(params: QuantizerParams, scale_speed: float) -> tuple:
    """The search kernels' tables' input: the scaled centers."""
    return (scaled_centers(params, scale_speed),)


class TablesCache:
    """A kernel's tables for the last ``size`` parameter versions and
    variants, so that an encode with frozen parameters builds them once.
    ``fields`` names the parameters the tables are made from and
    ``inputs(params, scale_speed)`` what of them ``tables`` takes
    (by default the scaled centers); a miss builds ``tables(*inputs,
    *variant)`` in the kernel's ``<name>.tables`` span, which records
    ``table_bytes=nbytes(tables)`` where ``nbytes`` is given.

    An entry is keyed by the named parameter tensors (the objects, held
    weakly: an entry keeps no parameter alive and goes when any of them is
    freed), the scale speed and the variant (a tuple of the kernel's table
    options).  It stands while each of those tensors keeps the version
    counter, storage, device and dtype it had at its build.  In-place writes
    bump the counters (an optimiser's step, ``copy_``, ``load_state_dict``);
    a write through ``.data``, through another library's view of the same
    memory or by a collective bumps nothing and is not seen.  Inference
    tensors keep no counter, so under ``torch.inference_mode`` the tables
    are built each call.  Every hit shares the entry's tables: no consumer
    writes into them.  Only a build is recorded by the span; ``hits`` and
    ``misses`` count the lookups."""

    def __init__(self, size: int, name: str, tables, fields: Tuple[str, ...] = CENTERS,
                 inputs: Callable = centers_input, nbytes: Optional[Callable] = None):
        self.size, self.name, self.tables = size, name, tables
        self.fields, self.inputs, self.nbytes = fields, inputs, nbytes
        self.hits = self.misses = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # reentrant: a weakref callback can run inside a locked block
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def get(self, params: QuantizerParams, scale_speed: float, *variant):
        """The tables of ``params`` for the variant, from the cache or
        built and stored."""
        ts = tuple(getattr(params, f) for f in self.fields)
        if torch.is_inference_mode_enabled() or any(t.is_inference() for t in ts):
            return self.build(params, scale_speed, variant)
        key = (*map(id, ts), float(scale_speed), variant)
        state = tuple((t._version, t.data_ptr(), t.device, t.dtype) for t in ts)
        with self._lock:
            entry = self._entries.get(key)
            if (entry is not None and all(r() is t for r, t in zip(entry[0], ts))
                    and entry[1] == state):
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[2]
            self.misses += 1
        tables = self.build(params, scale_speed, variant)
        drop = functools.partial(self._drop, key)
        with self._lock:
            self._entries[key] = (tuple(weakref.ref(t, drop) for t in ts), state, tables)
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        return tables

    @torch.no_grad()  # tables with a graph would keep the parameters alive
    def build(self, params: QuantizerParams, scale_speed: float, variant):
        with span(f"{self.name}.tables") as sp:
            tables = self.tables(*self.inputs(params, scale_speed), *variant)
            if self.nbytes is not None:
                sp.set(table_bytes=self.nbytes(tables))
            return tables

    def _drop(self, key, ref) -> None:
        """A weakref's callback: remove ``key``'s entry if ``ref`` is one of
        its references (a newer entry under the key has its own)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and any(r is ref for r in entry[0]):
                del self._entries[key]
