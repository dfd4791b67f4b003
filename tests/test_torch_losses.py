"""The training loss, product growth and codebook correlations: the port
against the JAX package on the same parameters and frames (numpy, seeded).

The kernel searches run as the JAX package's own tests run them on the CPU:
the Pallas kernels in interpret mode (``losses.py`` imports them at call
time, so the tests patch the module attributes), against the port's plain
versions.  Loss terms and gradients are f32 sums taken in another order on
each side, so they are compared with relative tolerances: 1e-5 for the loss
values and ``rtol=2e-4, atol=2e-5`` (the JAX trainer tests' own) for the
gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantization_tpu import core as jcore
from quantization_tpu.ops import gramv3 as jg3
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu.train.trainer import total_loss as jtotal
from quantization_tpu_torch import Quantizer
from quantization_tpu_torch import core as tcore
from quantization_tpu_torch.train.trainer import total_loss as ttotal
from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS, params_from_numpy

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(jg3, "gramv3_encode_indexes",
                        functools.partial(jg3.gramv3_encode_indexes, interpret=True))
    monkeypatch.setattr(jseq, "seqbeam_encode_indexes",
                        functools.partial(jseq.seqbeam_encode_indexes, interpret=True))


def _setup(dim, cs, nc, B, seed):
    """Trained-like parameters (nonzero scales, prediction weights near the
    codewords) and frames near sums of codewords."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, cs, dim)).astype(np.float32) * 0.5
    arrays = {
        "centers": centers,
        "to_logits_w": (centers.reshape(nc * cs, dim)
                        + 0.5 * rng.standard_normal((nc * cs, dim))).astype(np.float32),
        "to_logits_b": (0.1 * rng.standard_normal(nc * cs)).astype(np.float32),
        "logits_scale": np.float32(0.01),
        "centers_scale": np.float32(-0.02),
    }
    x = (centers[np.arange(nc)[None], rng.integers(0, cs, (B, nc))].sum(1)
         + 1.0 * rng.standard_normal((B, dim))).astype(np.float32)
    jc = jcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    tc = tcore.QuantizerConfig(dim=dim, codebook_size=cs, num_codebooks=nc)
    jp = jcore.QuantizerParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return arrays, x, jc, jp, tc


@pytest.mark.parametrize("search,iters", [
    ("beam", 0), ("beam", 1), ("beam", 2), ("cd", 1),
    ("seqbeam", 1), ("gramv3", 1), ("gramv3-int8", 2),
])
def test_losses_and_gradients_match_jax(interpret_kernels, search, iters):
    arrays, x, jc, jp, tc = _setup(128, 256, 2, 64, 11)

    def jloss(p):
        losses = jcore.compute_loss(p, jc, jnp.asarray(x), iters, search_method=search)
        return jtotal(losses), losses

    jgrads, jlosses = jax.grad(jloss, has_aux=True)(jp)

    tp = params_from_numpy(arrays)
    for f in PARAM_FIELDS:
        getattr(tp, f).requires_grad_(True)
    tlosses = tcore.compute_loss(tp, tc, torch.from_numpy(x), iters, search_method=search)
    ttotal(tlosses).backward()

    for name, want in jlosses._asdict().items():
        got = getattr(tlosses, name)
        np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL, err_msg=name)
    assert not tlosses.index_entropy_loss.requires_grad
    for f in PARAM_FIELDS:
        got = getattr(tp, f).grad.numpy()
        want = np.asarray(getattr(jgrads, f)).reshape(got.shape)
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=f)


def test_search_method_must_be_known():
    arrays, x, _, _, tc = _setup(16, 16, 2, 8, 0)
    with pytest.raises(ValueError):
        tcore.compute_loss(params_from_numpy(arrays), tc, torch.from_numpy(x), 1, "nope")


@pytest.mark.parametrize("dim,cs,nc", [(16, 16, 4), (32, 4, 8)])
def test_product_params_and_correlations_match_jax(dim, cs, nc):
    arrays, x, jc, jp, tc = _setup(dim, cs, nc, 32, 3)
    tp = params_from_numpy(arrays)
    want = jcore.product_params(jp, jc)
    got = tcore.product_params(tp, tc)
    for f in PARAM_FIELDS:  # sums of two f32 values: exact
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)).reshape(getattr(got, f).shape))
    # reconstructions are preserved across the growth (pairs of codes)
    pc = tc.product_config()
    idx = torch.randint(0, cs, (32, nc), generator=torch.Generator().manual_seed(0))
    pidx = idx[:, 0::2] * cs + idx[:, 1::2]  # k1*cs + k2
    np.testing.assert_allclose(
        tcore.decode_indexes(tcore.scaled_centers(got, pc.scale_speed), pidx).numpy(),
        tcore.decode_indexes(tcore.scaled_centers(tp, tc.scale_speed), idx).numpy(),
        rtol=1e-5, atol=1e-5)
    # correlations: f32 sums of products in another order; symmetric, unit diagonal
    corr = tcore.codebook_correlations(tp, tc).numpy()
    np.testing.assert_allclose(corr, np.asarray(jcore.codebook_correlations(jp, jc)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.diag(corr), 1.0, rtol=1e-5)


def test_quantizer_surface_matches_jax():
    from quantization_tpu.models.quantizer import Quantizer as JQuantizer

    arrays, x, jc, jp, tc = _setup(16, 16, 4, 32, 5)
    jq = JQuantizer(16, 16, 4, params=jp)
    tq = Quantizer(16, 16, 4, params=params_from_numpy(arrays), device="cpu")
    tl = tq.compute_loss(torch.from_numpy(x), refine_indexes_iters=1)
    jl = jq.compute_loss(jnp.asarray(x), refine_indexes_iters=1)
    for name, want in jl._asdict().items():
        np.testing.assert_allclose(float(getattr(tl, name).detach()), float(want), **LOSS_TOL)
    ttotal(tl).backward()  # gradients reach the module's parameters
    assert tq.centers.grad is not None and tq.to_logits.weight.grad is not None
    np.testing.assert_allclose(tq.compute_codebook_correlations().numpy(),
                               np.asarray(jq.compute_codebook_correlations()),
                               rtol=1e-4, atol=1e-5)
    tpq, jpq = tq.get_product_quantizer(), jq.get_product_quantizer()
    assert (tpq.codebook_size, tpq.num_codebooks) == (jpq.codebook_size, jpq.num_codebooks)
    assert tpq.get_id() != tq.get_id() and tpq.device == tq.device
    np.testing.assert_array_equal(tpq.centers.detach().numpy(), np.asarray(jpq.params.centers))
