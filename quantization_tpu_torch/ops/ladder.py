"""Auto's ladder: one table of :class:`Rung` records, the kernel
configurations ``search_method="auto"`` may run, and the gate that picks
one by each rung's rows in ``verified.json`` and ``quality.json``."""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..core.types import QuantizerConfig
from .beam_common import SearchKernel
from .gramv3 import GRAMV3
from .seqbeam import NARROW_DIM, SEQBEAM, SEQBEAM_SUPPORTED
from .verify import combined_margin_pct, kernel_verified


class Rung(NamedTuple):
    """A kernel configuration: its gate name, its kernel, its passes, the
    problem's arguments (``beam``), the TPU scheduling knobs the JAX ladder
    lists beside them (the K2 wrapper checks them; no result changes), the
    fewest frames a call takes it for, and whether it needs a quality row."""

    name: str
    kernel: SearchKernel
    passes: int
    beam: dict
    knobs: dict = {}
    min_frames: int = 0
    needs_quality: bool = False

    def kwargs(self) -> dict:  # the public wrapper's, besides ``passes``
        return {**self.beam, **self.knobs}


_ALT = dict(M=8, R=4, pool_mask="altparity")
_KNOBS = dict(block_b=256, interleave=2, reorder="select")
# the configurations whose rows were measured before a rung's name carried
# its codebooks: their names give the dim alone
_DIM_TAGS = {(512, 8): "d512", (256, 4): "d256", (1280, 8): "d1280"}


def config_tag(dim: int, num_codebooks: int) -> str:
    """The configuration's part of a rung's name: ``d<dim>`` for the
    first three configurations, ``d<dim>_b<num_codebooks>`` for any other,
    so that no configuration reads another's guard rows."""
    return _DIM_TAGS.get((dim, num_codebooks), f"d{dim}_b{num_codebooks}")


def _gram(dim: int, min_frames: int, num_codebooks: int = 8, passes: int = 3) -> Rung:
    # the beam of the K2 rungs behind it with the bf16 Gram table in place of
    # the per-candidate error; below min_frames K2 encodes as fast or faster
    # end to end on the H100 (whole calls, experiments/rung_times.py)
    return Rung(f"gramv3_bf16_alt{passes}_{config_tag(dim, num_codebooks)}", GRAMV3, passes,
                dict(_ALT, g_dtype="bf16"), min_frames=min_frames, needs_quality=True)


def _int8e(dim: int) -> Rung:
    return Rung(f"seqbeam_int8e_d{dim}", SEQBEAM, 3, dict(_ALT, e_dtype="int8"),
                dict(_KNOBS, block_b=512, zip_skew=1), needs_quality=True)


def _hl(dim: int, passes: int) -> Rung:
    return Rung(f"seqbeam_hl_d{dim}", SEQBEAM, passes, dict(_ALT, e_dtype="bf16"), _KNOBS)


# auto's rungs by (dim, num_codebooks), fastest first: K2's are the JAX ladder's
# (quantization_tpu/core/codec.py:118-145) and d1280 / 8 B's own; K3's leads where
# the card's guard rows hold it within the bar and it encodes faster.  d1280 /
# 16 B has K3's rung alone, for every call size: K2 has never run 16 codebooks
# above dim 1024, and a call the rung refuses runs the exact beam.  Its beam
# takes 4 passes: at 3 its worst guard seed reads +1.10% (combined 1.11%,
# past the 1% bar), at 4 +0.90%
LADDERS = {
    (512, 8): (_gram(512, 1536), _int8e(512), _hl(512, 3),
               Rung("seqbeam_m16_d512", SEQBEAM, 2, dict(M=16, R=4, e_dtype="bf16"), _KNOBS)),
    (256, 4): (_hl(256, 2),),
    (1280, 8): (_gram(1280, 768), _int8e(1280), _hl(1280, 3)),
    (1280, 16): (_gram(1280, 0, 16, passes=4),),
}


def rungs(config: QuantizerConfig) -> tuple:
    """``config``'s ladder: its :data:`LADDERS` entry, each rung where its
    kernel takes ``config``; else d512's K2 rungs where K2 takes ``config``
    up to ``NARROW_DIM``; else none (auto runs the exact beam)."""
    ladder = LADDERS.get((config.dim, config.num_codebooks))
    if ladder is not None:
        return tuple(r for r in ladder if r.kernel.supported(config))
    if SEQBEAM_SUPPORTED(config) and config.dim <= NARROW_DIM:
        return tuple(r for r in LADDERS[(512, 8)] if r.kernel is SEQBEAM)
    return ()


def pick(config: QuantizerConfig, x, refine_indexes_iters: int) -> Optional[Rung]:
    """The rung ``"auto"`` runs on (B, dim) frames ``x``, or None for the
    exact beam (off the GPU, as the JAX package's auto off the TPU): for a
    CUDA tensor and at least 3 iterations, the first of :func:`rungs` that
    takes B frames and has a passing smoke entry and a combined margin
    (train ratio x worst-seed encode delta) within the 1% bar, or no quality
    row where it needs none."""
    if not (x.is_cuda and refine_indexes_iters >= 3):
        return None
    for rung in rungs(config):
        margin = combined_margin_pct(rung.name)
        if x.shape[0] < rung.min_frames or (margin is None and rung.needs_quality):
            continue
        if kernel_verified(rung.name) and (margin is None or margin <= 1.0):
            return rung
    return None
