"""Faults planted in the program's encode underneath a run, for the tests
and the control runs that show the check fails them.  Each is a context
manager that patches the program's own functions for its duration:

* ``stale``: the step returns its state unchanged: the search hands back
  its initial indexes;
* ``half``: half of the batch left out: the second half's codes are the
  first half's;
* ``altered``: an answer altered where it is produced: the first byte of
  every frame's code.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("stale", "half", "altered")


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield old
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def encode_fault(kind: str):
    import quantization_tpu_torch.core as core
    from quantization_tpu_torch.core import search
    from quantization_tpu_torch.ops import seqbeam

    with contextlib.ExitStack() as stack:
        if kind == "stale":
            def kernel(params, config, x, passes=3, init_indexes=None, **kw):
                logits = search.compute_logits(params, config, x)
                return torch.argmax(logits, dim=-1).to(torch.int32)

            stack.enter_context(_patched(seqbeam, "seqbeam_encode_indexes", kernel))
            stack.enter_context(_patched(search, "refine_indexes",
                                         lambda centers, x, indexes, reducer=None: indexes))
        elif kind in ("half", "altered"):
            orig = core.encode

            def encode(params, config, x, *args, **kw):
                if kind == "half":
                    h = (x.shape[0] + 1) // 2
                    codes = orig(params, config, x[:h], *args, **kw)
                    return torch.cat([codes, codes[:x.shape[0] - h]])
                codes = orig(params, config, x, *args, **kw).clone()
                codes[:, 0] = codes[:, 0] ^ 1
                return codes

            stack.enter_context(_patched(core, "encode", encode))
        else:
            raise ValueError(f"unknown fault {kind!r}")
        yield
