"""Gradient (activation) checkpointing.

PyTorch counterpart of ``quantization_tpu/utils/checkpoint.py``: the
reference's hand-rolled ``autograd.Function`` that re-runs the forward
inside backward (`quantization/checkpoint.py:7-42`), here on
``torch.utils.checkpoint``.

Both functions use the non-reentrant variant.  The reentrant one gives no
gradient to tensors that ``function`` only reads (parameters held in a
closure or a dataclass) when none of its tensor *arguments* requires grad,
which is the predictor's case: its features and indexes do not.
"""

from __future__ import annotations

import functools

from torch.utils import checkpoint as _checkpoint


def checkpoint(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward pass instead of saved."""
    return _checkpoint.checkpoint(function, *args, use_reentrant=False, **kwargs)


def remat(fn):
    """``fn`` wrapped so that every call runs under :func:`checkpoint` (the
    decorator form, as ``jax.checkpoint``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, **kwargs)

    return wrapped
