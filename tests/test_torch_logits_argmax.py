"""The initial indexes' split-TF32 arithmetic (``ops/logits_argmax.py``) on
the CPU: its plain version against the f64 argmax on the three trained
quantizers' frames, the split of the weights, their layout, their cache,
ties and NaNs, and the CPU's initial indexes, which stay
``compute_logits``' argmax.  The kernel itself is held to the same judge
on the card by ``tests/test_torch_gpu.py``.  Imports no JAX."""

import dataclasses
import pathlib

import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch import load_quantizer
from quantization_tpu_torch.core import search
from quantization_tpu_torch.data.synthetic import make_mlp_sampler
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import logits_argmax as tla

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAINED = {256: ROOT / "experiments/q256_4_full.npz", 512: ROOT / "experiments/q512_8_full.npz",
           1280: ROOT / "quantization_tpu_torch/experiments/q1280_8_full.npz"}
CACHE = tla.TABLES_CACHE


@pytest.fixture(autouse=True)
def _empty_cache():
    CACHE.clear()
    yield
    CACHE.clear()


def _trained(dim):
    q = load_quantizer(TRAINED[dim], device="cpu")
    x = make_mlp_sampler(dim, device="cpu")(torch.Generator().manual_seed(3), 96)
    return q, x


def _random(dim=80, nc=4, seed=0):
    q = qtt.Quantizer(dim, 256, nc, generator=torch.Generator().manual_seed(seed), device="cpu")
    return q, torch.randn(40, dim, generator=torch.Generator().manual_seed(seed + 1))


def _fresh(q):
    with torch.no_grad():
        return tla.logits_tables(*tla.table_inputs(q.params, q.config.scale_speed))


# the trained quantizers on their sampler's frames, and a seeded one whose dim
# (80) is not a multiple of the kernel's 32-dim chunk
CASES = {"d256": lambda: _trained(256), "d512": lambda: _trained(512),
         "d1280": lambda: _trained(1280), "random_d80": _random}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_the_f64_argmax_wherever_it_is_decided(case):
    q, x = CASES[case]()
    got = tla.logits_argmax_plain(x, _fresh(q))
    want, decided = tla.f64_argmax(q.params, q.config, x)
    assert float(decided.float().mean()) > 0.99
    assert torch.equal(got[decided], want[decided])


@pytest.mark.parametrize("dim", list(TRAINED))
def test_the_split_reconstructs_the_scaled_weights(dim):
    q = load_quantizer(TRAINED[dim], device="cpu")
    tables = _fresh(q)
    w, _ = tla.scaled_logits(q.params, q.config.scale_speed)
    hi, lo = tla.weight_unlayout(tables.w_hi), tla.weight_unlayout(tables.w_lo)
    for part in (hi, lo):  # TF32 values: the 13 low mantissa bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (hi[:, :dim].double() + lo[:, :dim].double() - w.double()).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    assert tables.dim == dim and tables.padded_dim == dim


def test_the_layout_puts_each_weight_where_the_kernel_reads_it():
    nc, Dp = 2, 64
    w = torch.arange(nc * 256 * Dp, dtype=torch.float32).reshape(nc * 256, Dp)
    laid = tla.weight_layout(w)
    assert torch.equal(tla.weight_unlayout(laid), w)
    # laid[c, q, s, g, h, r, e] holds row 256 c + 8 g + r, dim 32 q + 8 e + 2 s + h
    for c, q, s, g, h, r, e in ((0, 0, 0, 0, 0, 0, 0), (1, 1, 3, 31, 1, 7, 3),
                                (0, 1, 2, 5, 0, 3, 1), (1, 0, 1, 17, 1, 6, 2)):
        assert laid[c, q, s, g, h, r, e] == w[256 * c + 8 * g + r, 32 * q + 8 * e + 2 * s + h]


def test_dims_beyond_the_last_chunk_are_zero_padded():
    q, _ = _random(80)
    tables = _fresh(q)
    assert tables.padded_dim == 96 and tables.dim == 80
    assert not bool(tla.weight_unlayout(tables.w_hi)[:, 80:].any())
    assert not bool(tla.weight_unlayout(tables.w_lo)[:, 80:].any())


def test_tables_of_another_type_or_shape_raise_at_construction():
    q, _ = _random()
    tables = _fresh(q)
    for change in (dict(w_hi=tables.w_hi.double()), dict(bias=tables.bias[:-1]),
                   dict(w_lo=tables.w_lo[:, :1]), dict(dim=tables.dim - 32),
                   dict(w_hi=tables.w_hi.transpose(0, 1))):
        with pytest.raises(TypeError, match="logits tables"):
            dataclasses.replace(tables, **change)


def test_the_kernel_wrapper_refuses_cpu_frames():
    q, x = _random(96)
    with pytest.raises(ValueError, match="CUDA"):
        tla.logits_argmax_cuda(x, _fresh(q))


@pytest.mark.parametrize("cs,frame_dim,match", [(16, 64, "256 codewords"), (256, 63, "frames")])
def test_the_kernel_entry_refuses_another_codebook_size_or_dim(cs, frame_dim, match):
    q = qtt.Quantizer(64, cs, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match=match):
        tla.logits_argmax(q.params, q.config, torch.zeros(3, frame_dim))


def _write(q, field):
    with torch.no_grad():
        getattr(q.params, field).add_(0.01)


@pytest.mark.parametrize("field", ["to_logits_w", "to_logits_b", "logits_scale"])
def test_a_write_to_its_parameters_misses_and_rebuilds_as_fresh(field):
    q, _ = _random()
    first = CACHE.get(q.params, q.config.scale_speed)
    assert CACHE.get(q.params, q.config.scale_speed) is first
    hits, misses = CACHE.hits, CACHE.misses
    _write(q, field)
    got = CACHE.get(q.params, q.config.scale_speed)
    assert (CACHE.hits, CACHE.misses) == (hits, misses + 1)
    assert got is not first
    fresh = _fresh(q)
    for f in ("w_hi", "w_lo", "bias"):
        assert torch.equal(getattr(got, f), getattr(fresh, f)), f
    assert not torch.equal(getattr(got, "bias" if field == "to_logits_b" else "w_hi"),
                           getattr(first, "bias" if field == "to_logits_b" else "w_hi"))


def test_a_write_to_the_centers_only_hits():
    q, _ = _random()
    first = CACHE.get(q.params, q.config.scale_speed)
    hits, misses = CACHE.hits, CACHE.misses
    for field in ("centers", "centers_scale"):
        _write(q, field)
    assert CACHE.get(q.params, q.config.scale_speed) is first
    assert (CACHE.hits, CACHE.misses) == (hits + 1, misses)


def test_ties_go_to_the_lowest_index_and_nans_follow_torch_argmax():
    q, x = _random(64, nc=2)
    with torch.no_grad():
        w, b = q.params.to_logits_w, q.params.to_logits_b
        w[9] = w[5]  # codebook 0: columns 5 and 9 tie, above the rest
        b[5] = b[9] = 1e3
        w[256:512] = 0.0  # codebook 1: every column equal
        b[256:512] = 0.0
    tables = _fresh(q)
    got = tla.logits_argmax_plain(x, tables)
    assert got[:, 0].eq(5).all() and got[:, 1].eq(0).all()
    with torch.no_grad():
        b[256 + 200] = b[256 + 100] = float("nan")  # codebook 1: the first NaN wins
    x[3, 7] = float("nan")  # a frame of NaN logits: index 0 everywhere
    got = tla.logits_argmax_plain(x, _fresh(q))
    rest = torch.arange(x.shape[0]) != 3
    assert got[rest, 1].eq(100).all() and got[rest, 0].eq(5).all()
    assert got[3].eq(0).all()


@pytest.mark.parametrize("case", ["d512", "random_d80"])
def test_initial_indexes_on_the_cpu_stay_compute_logits_argmax(case):
    q, x = CASES[case]()
    counts = (CACHE.hits, CACHE.misses)
    got = tbeam.initial_indexes(q.params, q.config, x)
    want = search.compute_logits(q.params, q.config, x).argmax(dim=-1).to(torch.int32)
    assert torch.equal(got, want)
    assert (CACHE.hits, CACHE.misses) == counts and len(CACHE) == 0
