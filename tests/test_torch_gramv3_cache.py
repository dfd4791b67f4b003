"""The gramv3 tables cache (``ops/gramv3.py::TABLES_CACHE``), on the CPU.

``gramv3_problem`` takes what depends on the parameters alone (the f32
scaled centers, their bf16 copy, the laid-out Gram table and int8's
``inv``) from the cache, under the seqbeam cache's key rule
(``ops/beam_common.py::TablesCache``).  A lookup on unchanged parameters
returns the stored tables; after a change of the parameters, the table
dtype or the scale speed it builds them again, equal to a fresh
``gramv3_tables(scaled_centers(...))``; and a problem made from the cache
equals, field for field, one computed from the parameters without it.
The card's path is held by ``tests/test_torch_gpu.py``."""

import dataclasses
import gc
import weakref

import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.core import scaled_centers
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.utils import spans

DIM, NC, B = 96, 4, 12
CACHE = tg3.TABLES_CACHE
G_DTYPES = ("bf16", "int8")


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


def _problem(params, config, g_dtype="bf16", x=None):
    return tg3.gramv3_problem(params, config, _frames() if x is None else x, M=8, R=4,
                              passes=2, pool_mask="altparity", g_dtype=g_dtype)


def _tables(params, config, g_dtype="bf16"):
    return CACHE.get(params, config.scale_speed, g_dtype)


@torch.no_grad()
def _fresh(params, config, g_dtype="bf16"):
    return tg3.gramv3_tables(scaled_centers(params, config.scale_speed), g_dtype)


@torch.no_grad()
def _uncached_problem(params, config, g_dtype, x):
    """The problem computed from the parameters in one go, with no cache."""
    centers = scaled_centers(params, config.scale_speed).detach().float()
    ctab = centers.reshape(NC * 256, DIM).to(torch.bfloat16)
    gtil, inv = tg3.gram_table(ctab, NC, g_dtype)
    idx0 = tbeam.initial_indexes(params, config, x)
    xc, ss0 = tg3.cross_terms(x, ctab), tg3.root_scores(centers, idx0, x)
    if inv is not None:
        xc, ss0 = xc * inv, ss0 * inv
    return tg3.Gramv3Problem(x, xc, idx0, ss0, tg3.table_layout(gtil, NC), 8, 4, 2,
                             tbeam.pool_bits("altparity", NC, 2), g_dtype)


def _assert_fields_equal(got, want, cls):
    for f in dataclasses.fields(cls):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def _counts():
    return CACHE.hits, CACHE.misses


@pytest.mark.parametrize("g_dtype", G_DTYPES)
def test_hand_built_tables_of_another_type_raise_at_construction(g_dtype):
    # checked once, where they are made; no launch checks them again
    q = _quantizer()
    tables = _fresh(q.params, q.config, g_dtype)
    other = {"bf16": torch.int8, "int8": torch.bfloat16}[g_dtype]
    for change in (dict(gt=tables.gt.to(other)), dict(gt=tables.gt.float()),
                   dict(ctab=tables.ctab.float()), dict(centers=tables.centers.double()),
                   dict(inv=None if tables.inv is not None else torch.tensor(1.0))):
        with pytest.raises(TypeError, match="gramv3 tables"):
            dataclasses.replace(tables, **change)
    with pytest.raises(TypeError, match="contiguous"):
        dataclasses.replace(tables, gt=tables.gt.transpose(1, 2))


@pytest.mark.parametrize("g_dtype", G_DTYPES)
def test_unchanged_parameters_hit(g_dtype):
    q = _quantizer()
    _problem(q.params, q.config, g_dtype)
    first = _tables(q.params, q.config, g_dtype)
    hits, misses = _counts()
    second = _problem(q.params, q.config, g_dtype)
    assert second.gt is first.gt
    assert _counts() == (hits + 1, misses)
    _assert_fields_equal(first, _fresh(q.params, q.config, g_dtype), tg3.Gramv3Tables)
    assert (first.inv is None) == (g_dtype == "bf16")


@pytest.mark.parametrize("g_dtype", G_DTYPES)
def test_a_cached_problem_equals_an_uncached_one_field_for_field(g_dtype):
    q, x = _quantizer(), _frames(4)
    _problem(q.params, q.config, g_dtype, x)  # fills the cache
    hits = CACHE.hits
    got = _problem(q.params, q.config, g_dtype, x)
    assert CACHE.hits == hits + 1
    _assert_fields_equal(got, _uncached_problem(q.params, q.config, g_dtype, x),
                         tg3.Gramv3Problem)


def _centers_add(q):
    with torch.no_grad():
        q.centers.add_(0.01 * torch.randn(q.centers.shape, generator=torch.Generator()
                                          .manual_seed(5)))
    return q.params, q.config, "bf16"


def _scale_add(q):
    with torch.no_grad():
        q.centers_scale.add_(0.01)
    return q.params, q.config, "bf16"


def _trainer_step(q):
    t = qtt.QuantizerTrainer(DIM, NC, device="cpu", phase_one_iters=1,
                             phase_two_iters=4, seed=0, diagnostics=False,
                             train_search="gramv3", beam_finetune_iters=0)
    x = _frames(3).repeat(8, 1)
    for _ in range(2):  # phase one's steps, then the product quantizer (cs 256, nc 4)
        t.step(x)
    assert (t.config.codebook_size, t.config.num_codebooks) == (256, NC)
    _problem(t.params, t.config)
    centers = t.params.centers.detach().clone()
    t.step(x)  # an Adam step on the same tensors, in place
    assert not torch.equal(centers, t.params.centers)
    return t.params, t.config, "bf16"


def _scale_speed(q):
    return q.params, dataclasses.replace(q.config, scale_speed=q.config.scale_speed * 0.5), "bf16"


# each returns the (params, config, g_dtype) of the next lookup
CHANGES = {
    "centers_add": _centers_add,
    "centers_scale_add": _scale_add,
    "trainer_step": _trainer_step,
    "g_dtype": lambda q: (q.params, q.config, "int8"),
    "scale_speed": _scale_speed,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_change_misses_and_rebuilds_as_fresh(change):
    q = _quantizer()
    _problem(q.params, q.config)
    before = _tables(q.params, q.config)
    params, config, g_dtype = CHANGES[change](q)
    hits, misses = _counts()
    got = _problem(params, config, g_dtype)
    assert _counts() == (hits, misses + 1)
    tables = _tables(params, config, g_dtype)  # and then hits
    assert _counts() == (hits + 1, misses + 1)
    assert tables is not before and got.gt is tables.gt
    _assert_fields_equal(tables, _fresh(params, config, g_dtype), tg3.Gramv3Tables)


@pytest.mark.parametrize("made_in_inference_mode", [False, True])
def test_inference_mode_bypasses_the_cache(made_in_inference_mode):
    if made_in_inference_mode:
        with torch.inference_mode():
            q = _quantizer()
    else:
        q = _quantizer()
    counts, entries = _counts(), len(CACHE)
    with torch.inference_mode():
        first = _problem(q.params, q.config)
        second = _problem(q.params, q.config)
    assert second.gt is not first.gt
    assert _counts() == counts and len(CACHE) == entries
    want = _uncached_problem(q.params, q.config, "bf16", _frames())
    _assert_fields_equal(first, want, tg3.Gramv3Problem)
    _assert_fields_equal(second, want, tg3.Gramv3Problem)


def test_dropping_the_parameters_drops_their_entries():
    q = _quantizer()
    params = q.params.detach()
    for g_dtype in G_DTYPES:
        _problem(params, q.config, g_dtype)
    assert len(CACHE) == 2
    refs = [weakref.ref(params.centers), weakref.ref(params.centers_scale)]
    del q, params
    gc.collect()
    assert all(r() is None for r in refs)  # no entry keeps a parameter alive
    assert len(CACHE) == 0


def test_encode_builds_once_and_records_the_build_span_only_then():
    q, x = _quantizer(), _frames(2)

    def encode():
        return q.encode(x, search_method="gramv3", refine_indexes_iters=2,
                        pool_mask="altparity", as_bytes=False)

    hits, misses = _counts()
    spans.start()
    first, second = encode(), encode()
    records = spans.stop()
    assert torch.equal(first, second)
    assert _counts() == (hits + 1, misses + 1)
    calls = sorted((r for r in records if r.name == "quantizer.encode"), key=lambda r: r.start_ns)
    names = [[r.name for r in sorted(records, key=lambda r: r.start_ns)
              if r.call_id == c.span_id and r is not c and r.name.startswith("gramv3.")]
             for c in calls]
    # the CPU runs the plain search: no launch span
    assert names == [["gramv3.tables", "gramv3.init"], ["gramv3.init"]]
    with torch.no_grad():
        q.centers.mul_(-1.0)
    changed = encode()
    assert _counts() == (hits + 1, misses + 2)
    CACHE.clear()
    assert torch.equal(changed, encode())  # as a build without the cache
