"""The seqbeam tables cache (``ops/seqbeam.py::TABLES_CACHE``), on the CPU.

``seqbeam_problem`` takes its codebook tables from the cache.  A lookup on
unchanged parameters returns the stored tables; after any change of the
parameters, the variant or the scale speed it builds them again, and what
it returns equals a fresh ``seqbeam_tables(scaled_centers(...))`` element
for element.  The card's path is held by ``tests/test_torch_gpu.py``."""

import dataclasses
import gc
import os
import sys
import threading
import weakref

import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.core import scaled_centers
from quantization_tpu_torch.ops import seqbeam as tseq

DIM, NC, B = 128, 2, 12
CACHE = tseq.TABLES_CACHE
# seqbeam_problem's variant arguments, one of each set of tables (v1: its beam)
VARIANTS = {
    "f32": dict(e_dtype="f32"),
    "bf16": dict(e_dtype="bf16"),
    "int8": dict(e_dtype="int8"),
    "int8_bound": dict(e_dtype="int8", requant="bound"),
    "lazy": dict(e_dtype="bf16", lazy_r1=True, pool_mask="altparity"),
    "v1": dict(impl="v1", M=8, R=4),
}


@pytest.fixture(autouse=True)
def _empty_cache():
    CACHE.clear()
    yield
    CACHE.clear()


def _quantizer(seed=0):
    return qtt.Quantizer(DIM, 256, NC, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


def _frames(seed=1):
    return torch.randn(B, DIM, generator=torch.Generator().manual_seed(seed))


def _problem(params, config, variant="int8"):
    kw = {"M": 8, "R": 4, **VARIANTS[variant]}
    return tseq.seqbeam_problem(params, config, _frames(), kw.pop("M"), kw.pop("R"), 2, **kw)


@torch.no_grad()
def _fresh(params, config, variant="int8"):
    kw = VARIANTS[variant]
    return tseq.seqbeam_tables(scaled_centers(params, config.scale_speed),
                               kw.get("e_dtype", "f32"), kw.get("impl", "v2"),
                               kw.get("requant", "step"), kw.get("lazy_r1", False))


def _assert_tables_equal(got, want):
    for f in dataclasses.fields(tseq.SeqbeamTables):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name


def _counts():
    return CACHE.hits, CACHE.misses


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hand_built_tables_of_another_type_raise_at_construction(variant):
    # the tables are checked once, where they are made, and no launch
    # checks them again: a wrong dtype, a missing ring or a strided table
    # raises TypeError at construction
    q = _quantizer()
    tables = _fresh(q.params, q.config, variant)
    for f in dataclasses.fields(tseq.SeqbeamTables):
        t = getattr(tables, f.name)
        if t is None:
            continue
        if not f.name.startswith("chunks_"):
            with pytest.raises(TypeError, match="seqbeam tables"):
                dataclasses.replace(tables, **{f.name: t.double()})
        if t.ndim > 1:
            with pytest.raises(TypeError, match="contiguous"):
                dataclasses.replace(tables, **{f.name: t.transpose(-2, -1)})
    ring = ["chunks_bf16"] + (["chunks_i8"] if tables.centers_i8 is not None else [])
    for name in ring:
        with pytest.raises(TypeError, match="ring chunks"):
            dataclasses.replace(tables, **{name: None})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_unchanged_parameters_hit(variant):
    q = _quantizer()
    first = _problem(q.params, q.config, variant).tables
    hits, misses = _counts()
    second = _problem(q.params, q.config, variant).tables
    assert second is first
    assert _counts() == (hits + 1, misses)
    _assert_tables_equal(first, _fresh(q.params, q.config, variant))


def _centers_add(q, tmp_path):
    with torch.no_grad():
        q.centers.add_(0.01 * torch.randn(q.centers.shape, generator=torch.Generator()
                                          .manual_seed(5)))
    return q.params, q.config, "int8"


def _scale_add(q, tmp_path):
    with torch.no_grad():
        q.centers_scale.add_(0.01)
    return q.params, q.config, "int8"


def _trainer_step(q, tmp_path):
    t = qtt.QuantizerTrainer(DIM, NC, device="cpu", phase_one_iters=1,
                             phase_two_iters=4, seed=0, diagnostics=False,
                             train_search="seqbeam", beam_finetune_iters=0)
    x = _frames(3).repeat(8, 1)
    for _ in range(2):  # phase one's steps, then the product quantizer (cs 256, nc 2)
        t.step(x)
    assert (t.config.codebook_size, t.config.num_codebooks) == (256, NC)
    _problem(t.params, t.config)
    centers = t.params.centers.detach().clone()
    t.step(x)  # an Adam step on the same tensors, in place
    assert not torch.equal(centers, t.params.centers)
    return t.params, t.config, "int8"


def _reloaded(q, tmp_path):
    qtt.save_quantizer(tmp_path / "q.npz", q)
    again = qtt.load_quantizer(tmp_path / "q.npz", device="cpu")
    assert torch.equal(again.centers, q.centers)
    return again.params, q.config, "int8"


def _scale_speed(q, tmp_path):
    return q.params, dataclasses.replace(q.config, scale_speed=q.config.scale_speed * 0.5), "int8"


def _variant(name):
    return lambda q, tmp_path: (q.params, q.config, name)


# each returns the (params, config, variant) of the next lookup
CHANGES = {
    "centers_add": _centers_add,
    "centers_scale_add": _scale_add,
    "trainer_step": _trainer_step,
    "e_dtype": _variant("bf16"),
    "impl": _variant("v1"),
    "requant": _variant("int8_bound"),
    "lazy_r1": _variant("lazy"),
    "reloaded_equal_values": _reloaded,
    "scale_speed": _scale_speed,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_change_misses_and_rebuilds_as_fresh(change, tmp_path):
    q = _quantizer()
    before = _problem(q.params, q.config).tables
    params, config, variant = CHANGES[change](q, tmp_path)
    hits, misses = _counts()
    got = _problem(params, config, variant).tables
    assert _counts() == (hits, misses + 1)
    assert got is not before
    _assert_tables_equal(got, _fresh(params, config, variant))
    assert _problem(params, config, variant).tables is got  # and then hits


@pytest.mark.parametrize("made_in_inference_mode", [False, True])
def test_inference_mode_bypasses_the_cache(made_in_inference_mode):
    if made_in_inference_mode:
        with torch.inference_mode():
            q = _quantizer()
    else:
        q = _quantizer()
    counts, entries = _counts(), len(CACHE)
    with torch.inference_mode():
        first = _problem(q.params, q.config).tables
        second = _problem(q.params, q.config).tables
    assert second is not first
    assert _counts() == counts and len(CACHE) == entries
    _assert_tables_equal(first, _fresh(q.params, q.config))
    _assert_tables_equal(second, _fresh(q.params, q.config))


@pytest.mark.parametrize("held", ["quantizer", "detached_params"])
def test_dropping_the_parameters_drops_their_entries(held):
    q = _quantizer()
    params = q.params if held == "quantizer" else q.params.detach()
    for variant in ("int8", "bf16"):
        _problem(params, q.config, variant)
    assert len(CACHE) == 2
    refs = [weakref.ref(params.centers), weakref.ref(params.centers_scale)]
    del q, params
    gc.collect()
    assert all(r() is None for r in refs)  # no entry keeps a parameter alive
    assert len(CACHE) == 0


def test_the_cache_keeps_its_newest_entries():
    qs = [_quantizer(seed) for seed in range(CACHE.size + 2)]
    tables = [_problem(q.params, q.config).tables for q in qs]
    assert len(CACHE) == CACHE.size
    hits, misses = _counts()
    assert _problem(qs[-1].params, qs[-1].config).tables is tables[-1]
    assert _problem(qs[0].params, qs[0].config).tables is not tables[0]  # evicted
    assert _counts() == (hits + 1, misses + 1)


@pytest.mark.parametrize("as_bytes", [True, False])
def test_encode_reuses_tables_until_the_centers_change(as_bytes):
    q, x = _quantizer(), _frames(2)

    def encode():
        return q.encode(x, search_method="seqbeam", refine_indexes_iters=2, as_bytes=as_bytes)

    first = encode()
    hits, misses = _counts()
    assert torch.equal(encode(), first)
    assert _counts() == (hits + 1, misses)
    with torch.no_grad():
        q.centers.mul_(-1.0)
    changed = encode()
    assert _counts() == (hits + 1, misses + 1)
    assert not torch.equal(changed, first)
    CACHE.clear()
    assert torch.equal(changed, encode())  # as a build without the cache


def test_concurrent_lookups_count_every_one():
    """More threads than cores look up three parameter sets at once, with
    a short switch interval; every lookup is counted once and returns its
    own parameters' tables."""
    qs = [_quantizer(seed) for seed in range(3)]
    want = [_fresh(q.params, q.config) for q in qs]
    threads_n, rounds = (os.cpu_count() or 1) + 2, 40
    errors = []
    hits, misses = _counts()

    def work(i):
        try:
            for r in range(rounds):
                q = qs[(i + r) % len(qs)]
                got = CACHE.get(q.params, q.config.scale_speed, "int8", "v2", "step", False)
                if not torch.equal(got.centers_i8, want[(i + r) % len(qs)].centers_i8):
                    errors.append((i, r))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert CACHE.hits - hits + CACHE.misses - misses == threads_n * rounds
    assert CACHE.misses - misses >= len(qs) and len(CACHE) == len(qs)
