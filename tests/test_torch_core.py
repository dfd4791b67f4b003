"""The port's functional core held against the JAX package on the CPU.

Both packages get the same numpy-seeded inputs.  Integer results (packing,
search schedules, beam and coordinate-descent indexes) must be equal; float
results carry the tolerance stated at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.core import search as jsearch
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

FIELDS = ("centers", "to_logits_w", "to_logits_b", "logits_scale", "centers_scale")


def _params(dim, cs, nc, seed, centers_scale=0.0):
    """JAX-initialised parameters as numpy arrays, with a nonzero
    centers_scale available so that scaled_centers is exercised."""
    config = jcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    p = jcore.init_quantizer_params(jax.random.PRNGKey(seed), config)
    arrays = {k: np.asarray(getattr(p, k), np.float32) for k in FIELDS}
    arrays["centers_scale"] = np.float32(centers_scale)
    return arrays


def _both(arrays):
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jp, params_from_numpy(arrays)


@pytest.mark.parametrize("cs,nc", [(2, 16), (4, 8), (16, 8), (16, 2), (256, 4), (256, 8)])
def test_config_matches_jax(cs, nc):
    j = jcore.QuantizerConfig(dim=64, codebook_size=cs, num_codebooks=nc)
    t = tcore.QuantizerConfig(dim=64, codebook_size=cs, num_codebooks=nc)
    assert t.bytes_per_frame == j.bytes_per_frame
    if nc > 1 and cs <= 16:
        jp, tp = j.product_config(), t.product_config()
        assert (tp.codebook_size, tp.num_codebooks) == (jp.codebook_size, jp.num_codebooks)
    assert hash(t) == hash(tcore.QuantizerConfig(dim=64, codebook_size=cs, num_codebooks=nc))
    with pytest.raises(ValueError):
        tcore.QuantizerConfig(dim=64, codebook_size=cs + 1, num_codebooks=nc)


@pytest.mark.parametrize("cs,nc", [(256, 4), (16, 8), (4, 8), (2, 16)])
def test_pack_unpack_exact(cs, nc):
    # packs 1, 2, 4 and 8 codebooks per byte; integer arithmetic, so exact
    rng = np.random.default_rng(cs + nc)
    idx = rng.integers(0, cs, size=(37, nc)).astype(np.int32)
    jpacked = np.asarray(jcore.pack_indexes(jnp.asarray(idx), cs))
    tpacked = tcore.pack_indexes(torch.from_numpy(idx), cs)
    assert tpacked.dtype == torch.uint8
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    np.testing.assert_array_equal(tcore.unpack_indexes(tpacked, cs, nc).numpy(), idx)


@pytest.mark.parametrize("num_repeats", [1, 2, 4, 8, 16])
def test_unpack_matches_jax(num_repeats):
    # unpack also takes widths that pack never produces (16 per value):
    # the same integer expansion as the JAX package, exactly
    cs, nc = 2, 32
    rng = np.random.default_rng(num_repeats)
    packed = rng.integers(0, cs ** num_repeats, size=(9, nc // num_repeats)).astype(np.int32)
    want = np.asarray(jcore.unpack_indexes(jnp.asarray(packed), cs, nc))
    got = tcore.unpack_indexes(torch.from_numpy(packed), cs, nc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_search_schedule_matches_jax():
    for cs in (4, 16, 256):
        for L in (1, 2, 4, 16, 1 << 20):
            assert tcore.k_cutoff_schedule(cs, L) == jcore.k_cutoff_schedule(cs, L)
        for nc in (2, 4, 8, 16):
            assert tcore.search_plan(nc, cs) == jcore.search_plan(nc, cs)


def test_init_params_distribution():
    config = tcore.QuantizerConfig(dim=64, codebook_size=16, num_codebooks=4)
    p = tcore.init_quantizer_params(torch.Generator().manual_seed(0), config)
    q = tcore.init_quantizer_params(torch.Generator().manual_seed(0), config)
    assert p.to_logits_w.shape == (64, 64) and p.to_logits_b.shape == (64,)
    assert torch.equal(p.centers, p.to_logits_w.reshape(4, 16, 64))
    assert torch.equal(p.to_logits_w, q.to_logits_w)  # a seed fixes the draw
    assert float(p.to_logits_w.abs().max()) <= 64 ** -0.5
    assert float(p.logits_scale) == 0.0 and float(p.centers_scale) == 0.0
    ident = tcore.random_id()
    assert len(ident) == 8 and int(ident, 16) >= 0


def test_compute_logits_and_centers_match_jax():
    arrays = _params(64, 256, 4, seed=1, centers_scale=0.03)
    arrays["logits_scale"] = np.float32(-0.02)
    jp, tp = _both(arrays)
    jc = jcore.QuantizerConfig(dim=64, codebook_size=256, num_codebooks=4)
    tc = tcore.QuantizerConfig(dim=64, codebook_size=256, num_codebooks=4)
    x = np.random.default_rng(2).standard_normal((33, 64)).astype(np.float32)
    want = np.asarray(jcore.compute_logits(jp, jc, jnp.asarray(x)))
    got = tcore.compute_logits(tp, tc, torch.from_numpy(x)).numpy()
    # f32 matmuls with different summation orders
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcore.scaled_centers(tp, 10.0).numpy(),
        np.asarray(jcore.scaled_centers(jp, 10.0)), rtol=1e-6)
    np.testing.assert_allclose(
        tcore.data_mean(tp, 10.0).numpy(),
        np.asarray(jcore.data_mean(jp, 10.0)), rtol=1e-5, atol=1e-7)


def _agree_or_tie(centers, x, got, want):
    """Index rows equal, or (a tie between options) equal reconstruction
    error to f32 rounding.  Returns the fraction of rows that are equal."""
    same = (got == want).all(axis=1)
    if not same.all():
        c = centers.astype(np.float64)
        nc = c.shape[0]

        def err(idx):
            return ((c[np.arange(nc)[None], idx].sum(1) - x) ** 2).sum(1)

        eg, ew = err(got[~same]), err(want[~same])
        np.testing.assert_allclose(eg, ew, rtol=1e-5)
    return same.mean()


@pytest.mark.parametrize("cs,nc,dim", [(16, 8, 64), (16, 4, 32), (256, 4, 64), (4, 2, 8)])
def test_refine_indexes_match_jax(cs, nc, dim):
    arrays = _params(dim, cs, nc, seed=11)
    rng = np.random.default_rng(cs * nc)
    # frames near the codebooks' span, so refinement has work to do
    c = arrays["centers"]
    pick = rng.integers(0, cs, size=(64, nc))
    x = (c[np.arange(nc)[None], pick].sum(1)
         + 0.3 * rng.standard_normal((64, dim)) * np.abs(c).mean()).astype(np.float32)
    idx0 = rng.integers(0, cs, size=(64, nc)).astype(np.int32)
    jc = jnp.asarray(c)
    tc = torch.from_numpy(c.copy())
    for name in ("beam", "cd"):
        if name == "beam":
            want = np.asarray(jcore.refine_indexes(jc, jnp.asarray(x), jnp.asarray(idx0)))
            got = tcore.refine_indexes(tc, torch.from_numpy(x), torch.from_numpy(idx0))
        else:
            want = np.asarray(jsearch.refine_indexes_cd(
                jc, jnp.asarray(x), jnp.asarray(idx0), sweeps=2))
            got = tcore.refine_indexes_cd(
                tc, torch.from_numpy(x), torch.from_numpy(idx0), sweeps=2)
        assert got.dtype == torch.int32 and got.shape == (64, nc)
        # equal indexes; a row may differ only where two options tie
        # (observed: every row equal, for both searches and all configs)
        assert _agree_or_tie(c, x, got.numpy(), want) >= 0.95, name


def test_compute_indexes_match_jax():
    arrays = _params(64, 16, 8, seed=3)
    jp, tp = _both(arrays)
    jc = jcore.QuantizerConfig(dim=64, codebook_size=16, num_codebooks=8)
    tc = tcore.QuantizerConfig(dim=64, codebook_size=16, num_codebooks=8)
    x = np.random.default_rng(4).standard_normal((40, 64)).astype(np.float32) * 0.2
    for search in ("beam", "cd"):
        want = np.asarray(jcore.compute_indexes(jp, jc, jnp.asarray(x), 2, search=search))
        got = tcore.compute_indexes(tp, tc, torch.from_numpy(x), 2, search=search)
        assert _agree_or_tie(arrays["centers"], x, got.numpy(), want) >= 0.95
    with pytest.raises(ValueError):
        tcore.compute_indexes(tp, tc, torch.from_numpy(x), 1, search="nope")


@pytest.mark.parametrize("cs,nc,dim", [(16, 8, 64), (256, 4, 32)])
def test_decode_indexes_and_onehot_match_jax(cs, nc, dim):
    arrays = _params(dim, cs, nc, seed=5, centers_scale=0.02)
    jp, tp = _both(arrays)
    idx = np.random.default_rng(6).integers(0, cs, size=(19, nc)).astype(np.int32)
    jcen = jcore.scaled_centers(jp, 10.0)
    tcen = tcore.scaled_centers(tp, 10.0)
    want = np.asarray(jcore.decode_indexes(jcen, jnp.asarray(idx)))
    for fn in (tcore.decode_indexes, tcore.decode_onehot):
        got = fn(tcen, torch.from_numpy(idx)).numpy()
        # sums of nc f32 rows in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    jc = jcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    tc = tcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    packed = np.asarray(jcore.pack_indexes(jnp.asarray(idx), cs))
    np.testing.assert_allclose(
        tcore.decode(tp, tc, torch.from_numpy(packed)).numpy(),
        np.asarray(jcore.decode(jp, jc, jnp.asarray(packed))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cs,nc,dim", [(16, 8, 64), (256, 4, 64), (4, 2, 8)])
def test_refine_indexes_reference_matches_jax_and_refine_indexes(cs, nc, dim):
    from quantization_tpu_torch.core import search as tsearch

    arrays = _params(dim, cs, nc, seed=13)
    rng = np.random.default_rng(cs + nc + dim)
    c = arrays["centers"]
    pick = rng.integers(0, cs, size=(48, nc))
    x = (c[np.arange(nc)[None], pick].sum(1)
         + 0.3 * rng.standard_normal((48, dim)) * np.abs(c).mean()).astype(np.float32)
    idx0 = rng.integers(0, cs, size=(48, nc)).astype(np.int32)
    args = (torch.from_numpy(c.copy()), torch.from_numpy(x), torch.from_numpy(idx0))
    got = tsearch.refine_indexes_reference(*args)
    assert got.dtype == torch.int32 and got.shape == (48, nc)
    want = np.asarray(jax.jit(jsearch.refine_indexes_reference)(
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(idx0)))
    # equal indexes (a row may differ only where two options tie; observed:
    # every row equal), and the oracle of the port's own beam
    assert _agree_or_tie(c, x, got.numpy(), want) == 1.0
    assert _agree_or_tie(c, x, got.numpy(), tsearch.refine_indexes(*args).numpy()) == 1.0


@pytest.fixture
def default_precisions():
    from quantization_tpu.core import precision as jprec
    from quantization_tpu_torch.core import precision as tprec

    yield jprec, tprec
    jprec.set_matmul_precision("highest")
    jprec.set_search_inner_precision("default")
    tprec.set_matmul_precision("highest")
    tprec.set_search_inner_precision("highest")


@pytest.mark.parametrize("p", ["highest", "high", "default", "float32", "bfloat16_3x",
                               "tensorfloat32", "bfloat16", "fastest", 0, 1, 2,
                               jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST,
                               "HIGHEST", "bogus", 3])
def test_precision_setters_match_jax(default_precisions, p):
    # TF32 is allowed exactly where the JAX package's level is not HIGHEST;
    # a name JAX refuses, the port refuses
    jprec, tprec = default_precisions
    assert not tprec.MATMUL_ALLOW_TF32 and not tprec.SEARCH_INNER_ALLOW_TF32  # the defaults
    try:
        jprec.set_matmul_precision(p)
    except ValueError:
        with pytest.raises(ValueError):
            tprec.set_matmul_precision(p)
        with pytest.raises(ValueError):
            tprec.set_search_inner_precision(p)
        return
    jprec.set_search_inner_precision(p)
    tprec.set_matmul_precision(p)
    tprec.set_search_inner_precision(p)
    tf32 = jprec.MATMUL_PRECISION != jax.lax.Precision.HIGHEST
    assert jprec.SEARCH_INNER_PRECISION == jprec.MATMUL_PRECISION
    assert tprec.MATMUL_ALLOW_TF32 == tprec.CUDNN_ALLOW_TF32 == tf32
    assert torch.backends.cuda.matmul.allow_tf32 == torch.backends.cudnn.allow_tf32 == tf32
    assert tprec.SEARCH_INNER_ALLOW_TF32 == tf32


@pytest.mark.parametrize("inner", ["highest", "default"])
def test_search_inner_precision_reaches_the_beams_combine_product(default_precisions,
                                                                  monkeypatch, inner):
    # the combine product runs with TF32 set as the search's inner
    # precision says and nothing else does; the setting is restored after
    from quantization_tpu_torch.core import search as tsearch

    _, tprec = default_precisions
    tprec.set_search_inner_precision(inner)
    seen, einsum = [], torch.einsum

    def recording(spec, *ops):
        seen.append((spec, torch.backends.cuda.matmul.allow_tf32))
        return einsum(spec, *ops)

    monkeypatch.setattr(tsearch.torch, "einsum", recording)
    arrays = _params(32, 16, 4, seed=17)
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    c = torch.from_numpy(arrays["centers"].copy())
    tsearch.refine_indexes(c, torch.from_numpy(x), torch.zeros(8, 4, dtype=torch.int32))
    combines = [tf32 for spec, tf32 in seen if spec == "bnkd,bnjd->bnkj"]
    assert len(combines) == 2 and set(combines) == {inner == "default"}
    assert all(not tf32 for spec, tf32 in seen if spec != "bnkd,bnjd->bnkj")
    assert not torch.backends.cuda.matmul.allow_tf32
