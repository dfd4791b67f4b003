"""B3, the rest of seqbeam v2: ``requant="pass"`` and ``"bound"`` (int8 E)
and ``lazy_r1`` (f32, bf16 and int8 E).  The port's plain version against
the JAX package's Pallas kernel in interpret mode (the CUDA kernel is held
against the plain version on a card in ``test_torch_gpu.py``), on the same
numpy-seeded parameters, frames and initial indexes.

The bar is at least 99% of indexes equal and the summed squared error within
1e-4 relative, because the root error's sum of squares, the bf16 rescores
and the Gram blocks are f32 sums taken in another order than XLA's and can
flip a near tie.  Observed: every index equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.ops import gramv3 as jg3
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.core import codec as tcodec
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import ladder as tladder
from quantization_tpu_torch.ops import quality_guard as tguard
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.ops import verify as tverify
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

CS, DIM, B, NC = 256, 128, 128, 4
# a valid explicit per-pass schedule for lazy_r1: each deferring R1 step
# (t = 1 of pass 0, t = 2 of pass 1) is followed by a pool step
SCHEDULE = ((True, False, True, True), (True, True, False, True))


def _problem(seed):
    """Trained-like codebooks: frames are sums of codewords plus noise, and
    the prediction weights point at the codewords."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((NC, CS, DIM)).astype(np.float32) * 0.5
    arrays = {
        "centers": centers,
        "to_logits_w": (centers.reshape(NC * CS, DIM)
                        + 0.5 * rng.standard_normal((NC * CS, DIM))).astype(np.float32),
        "to_logits_b": (0.1 * rng.standard_normal(NC * CS)).astype(np.float32),
        "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0),
    }
    x = (centers[np.arange(NC)[None], rng.integers(0, CS, (B, NC))].sum(1)
         + 2.0 * rng.standard_normal((B, DIM))).astype(np.float32)
    init = rng.integers(0, CS, (B, NC)).astype(np.int32)
    return arrays, x, init


def _sse(centers, idx, x):
    return float(((centers[np.arange(NC)[None], idx].sum(1) - x) ** 2).sum())


def _port(seed, **kw):
    # reorder="select": what the TPU wrapper needs for bf16 or int8 E and lazy_r1
    arrays, x, init = _problem(seed)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=NC)
    got = tseq.seqbeam_encode_indexes(params_from_numpy(arrays), tc, torch.from_numpy(x),
                                      init_indexes=torch.from_numpy(init), reorder="select", **kw)
    return arrays["centers"], x, init, got.numpy()


@pytest.mark.parametrize("kw", [
    dict(e_dtype="int8", requant="pass", pool_mask="altparity"),
    dict(e_dtype="int8", requant="pass"),
    dict(e_dtype="int8", requant="bound", pool_mask="altparity"),
    dict(e_dtype="int8", requant="bound", pool_mask=SCHEDULE),
    dict(e_dtype="f32", lazy_r1=True, pool_mask="altparity"),
    dict(e_dtype="bf16", lazy_r1=True, pool_mask="altparity"),
    dict(e_dtype="int8", lazy_r1=True, pool_mask="altparity"),
    dict(e_dtype="f32", lazy_r1=True, pool_mask=SCHEDULE),
], ids=["pass-alt", "pass-pool", "bound-alt", "bound-sched", "lazy-f32", "lazy-bf16",
        "lazy-int8", "lazy-f32-sched"])
def test_plain_matches_jax_interpret(kw):
    arrays, x, init = _problem(0)
    jc = jcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=NC)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = np.asarray(jseq.seqbeam_encode_indexes(
        jp, jc, jnp.asarray(x), M=8, R=4, passes=2, interpret=True, reorder="select",
        init_indexes=jnp.asarray(init), **kw))
    before = tseq.SEQBEAM_KERNEL.launches
    centers, x, init, got = _port(0, M=8, R=4, passes=2, **kw)
    assert tseq.SEQBEAM_KERNEL.launches == before  # a CPU tensor runs the plain version
    assert (got == want).mean() >= 0.99
    e_got, e_want = _sse(centers, got, x), _sse(centers, want, x)
    assert abs(e_got / e_want - 1.0) <= 1e-4, (e_got, e_want)
    assert e_got < _sse(centers, init, x)  # the search did work


@pytest.mark.parametrize("e_dtype", ["f32", "bf16", "int8"])
def test_lazy_r1_tracks_eager(e_dtype):
    # the JAX relation (tests/test_search_alternatives.py:698-731): not
    # bit-identical, >= 98% of indexes equal, squared error within 2e-3
    kw = dict(M=8, R=4, passes=2, pool_mask="altparity", e_dtype=e_dtype)
    centers, x, _, eager = _port(1, **kw)
    lazy = _port(1, lazy_r1=True, **kw)[3]
    assert (eager == lazy).mean() >= 0.98
    assert abs(_sse(centers, lazy, x) / _sse(centers, eager, x) - 1.0) <= 2e-3


@pytest.mark.parametrize("requant", ["pass", "bound"])
def test_frozen_and_bound_scales_track_step(requant):
    # the screened claim behind both: the search quality of step requant
    kw = dict(M=8, R=4, passes=2, pool_mask="altparity", e_dtype="int8")
    centers, x, init, step = _port(2, **kw)
    got = _port(2, requant=requant, **kw)[3]
    assert _sse(centers, got, x) < _sse(centers, init, x)
    assert abs(_sse(centers, got, x) / _sse(centers, step, x) - 1.0) <= 5e-3


@pytest.mark.parametrize("kw", [
    dict(requant="pass"), dict(requant="bound", e_dtype="bf16"), dict(requant="exact"),
    dict(lazy_r1=True), dict(lazy_r1=True, pool_mask="altparity", e_dtype="int8",
                             requant="bound"),
    dict(lazy_r1=True, pool_mask=(True, False, False, True)),
    dict(lazy_r1=True, pool_mask=((True, True, True, True), (True, True, False, False))),
])
def test_b3_refuses_what_jax_refuses(kw):
    arrays, x, _ = _problem(0)
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=NC)
    with pytest.raises(ValueError):
        tseq.seqbeam_encode_indexes(params_from_numpy(arrays), tc, torch.from_numpy(x), M=8, R=4,
                                    passes=2, reorder="select", **kw)


# scheduling knobs that change no result, in combinations the TPU wrappers
# assert against (quantization_tpu/ops/seqbeam.py:1762-1776,
# quantization_tpu/ops/gramv3.py:284, :400)
@pytest.mark.parametrize("search,kw", [
    ("seqbeam", dict(e_dtype="bf16")),  # bf16 E with the gather reorder
    ("seqbeam", dict(e_dtype="int8", reorder="select", cross_value=True)),
    ("seqbeam", dict(e_dtype="int8", pool_mask="altparity", lazy_r1=True)),  # gather reorder
    ("seqbeam", dict(zip_skew=1, pool_mask="altparity")),  # interleave=1: no sub-tiles
    ("gramv3", dict(interleave=3)),  # does not divide block_b=128
], ids=["bf16-gather", "int8-cross-value", "lazy-gather", "zip-skew-no-subtiles",
        "gramv3-interleave"])
def test_knobs_refused_where_jax_refuses(search, kw):
    arrays, x, init = _problem(0)
    jc = jcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=NC)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tc = tcore.QuantizerConfig(dim=DIM, codebook_size=CS, num_codebooks=NC)
    jfn, tfn = ((jseq.seqbeam_encode_indexes, tseq.seqbeam_encode_indexes) if search == "seqbeam"
                else (jg3.gramv3_encode_indexes, tg3.gramv3_encode_indexes))
    with pytest.raises(AssertionError):
        jfn(jp, jc, jnp.asarray(x), M=8, R=4, passes=2, init_indexes=jnp.asarray(init),
            interpret=True, **kw)
    with pytest.raises(ValueError):
        tfn(params_from_numpy(arrays), tc, torch.from_numpy(x), M=8, R=4, passes=2,
            init_indexes=torch.from_numpy(init), **kw)


def test_guard_candidates_leave_auto_unchanged(monkeypatch):
    # the quality guard measures the promotion candidates beside the ladder;
    # auto's ladder, and so its choice, is the ladder alone
    # (name, needs a quality row) of each rung
    ladder = {512: [("gramv3_bf16_alt3_d512", True), ("seqbeam_int8e_d512", True),
                    ("seqbeam_hl_d512", False), ("seqbeam_m16_d512", False)],
              256: [("seqbeam_hl_d256", False)]}
    first = {dim: rungs[0][0] for dim, rungs in ladder.items()}
    names = {"seqbeam_int8e_fi_d512", "seqbeam_int8e_bound_d512",
             "seqbeam_int8e_bound_fi_d512", "seqbeam_int8e_lazy_d512", "seqbeam_int8e_d256"}
    configs = {dim: tcore.QuantizerConfig(dim=dim, codebook_size=CS, num_codebooks=nc)
               for dim, nc in ((512, 8), (256, 4))}
    on_card = types.SimpleNamespace(is_cuda=True, shape=(8192, 512))  # a bulk call's frames
    # with the committed tables, which hold the candidates' rows too
    for name in names:
        assert tverify.kernel_verified(name) and tverify.quality_delta_pct(name) is not None
    assert tcodec.auto_choice(configs[512], on_card, 5)[0] == first[512]
    assert tcodec.auto_choice(configs[256], on_card, 5)[0] == first[256]
    seen = set()
    for dim, config in configs.items():
        assert [(r.name, r.needs_quality) for r in tladder.rungs(config)] == ladder[dim]
        for rung in tguard.CANDIDATES[(dim, config.num_codebooks)]:
            seen.add(rung.name)
            assert rung.kernel is tseq.SEQBEAM
            # every candidate is a problem the port takes
            kw, knobs = rung.beam, rung.knobs
            tseq._check_variant(kw["M"], kw["R"], config.num_codebooks, rung.passes,
                                kw.get("pool_mask"), kw["e_dtype"], "v2",
                                kw.get("requant", "step"), kw.get("lazy_r1", False))
            tseq._check_knobs("v2", kw["e_dtype"], kw.get("lazy_r1", False), kw.get("pool_mask"),
                              knobs["block_b"], knobs["interleave"], knobs.get("zip_skew", 0),
                              False, knobs["reorder"], "lohi")
    assert seen == names
    # even passing and better than the ladder, no candidate is chosen
    rows = {n: 0.9 for n, _ in ladder[512] + ladder[256]}
    rows.update({n: 0.1 for n in names})
    tables = {tverify.VERIFIED: {"results": {n: {"ok": True} for n in rows}},
              tverify.QUALITY: {"train_ratio_vs_torch": 1.0,
                                "results": {n: {"max_delta_pct": d} for n, d in rows.items()}}}
    monkeypatch.setattr(tverify, "_read", lambda path: tables[path])
    assert tcodec.auto_choice(configs[512], on_card, 5)[0] == first[512]
    assert tcodec.auto_choice(configs[256], on_card, 5)[0] == first[256]
