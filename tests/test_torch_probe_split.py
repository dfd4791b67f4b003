"""The exact three-way bf16 split of c that the "bf16" rescore chain's
tensor-core kernel (P5, ``csrc/int8_mxu_probe.cu``) runs on, in plain
PyTorch on the CPU.

c = c_hi + c_mid + c_lo, each bf16, by round-to-nearest of successive
remainders (``bf16_split``, the kernel's rule).  E and bf16(cross) are bf16,
so every product of one of them with a part is exact in f32, and each f32
product of the chain becomes three bf16 products summed in f32
(``bf16_chain_split_model``).  Tolerances: the split bit for bit; the model
against ``bf16_chain_plain`` with the card's bar (``bf16_chain_agreement``)
on the script's distribution; one step's products within the f32 rounding of
their sums on E with tiny elements, and one step of the chain within the
bounds that rounding allows (``bf16_step_bounds``, which the card's kernel
is held to as well).
"""

import numpy as np
import pytest
import torch

from quantization_tpu_torch.experiments import int8_mxu_probe as tprobe


def _log_uniform(seed, scale, shape=(256, 512)):
    """Magnitudes log-uniform in [scale, 10 scale), random signs."""
    rng = np.random.default_rng(seed)
    mag = scale * 10.0 ** rng.random(shape)
    return torch.from_numpy((mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32))


def _script_c(seed=0):
    """c as the script draws it: normal x 0.05, (256, 512)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((256, 512)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("scale", [None, 1e-30, 1e-20, 1e-10, 1e-3, 1.0, 1e3])
def test_split_is_exact(scale):
    c = _script_c() if scale is None else _log_uniform(1, scale)
    hi, mid, lo = tprobe.bf16_split(c)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(total.view(torch.int32), c.view(torch.int32))
    # each part holds what the one before it could not: at most half its ulp
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all())


def _chain_inputs(seed, mb, tiny_frac=0.0):
    """E normal and c normal x 0.05, the script's distributions, with a
    share ``tiny_frac`` of E's elements scaled by 1e-5."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((mb, 512)).astype(np.float32)
    c = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    if tiny_frac:
        e = np.where(rng.random(e.shape) < tiny_frac, e * 1e-5, e).astype(np.float32)
    return torch.from_numpy(e), torch.from_numpy(c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_model_meets_the_cards_bar(seed):
    e, c = _chain_inputs(seed, 256)
    want = tprobe.bf16_chain_plain(e, c)
    chk = tprobe.bf16_chain_agreement(tprobe.bf16_chain_split_model(e, c), want, e)
    assert chk["ok"], chk


def test_split_products_exact_on_tiny_elements():
    # E with a quarter of tiny elements (the inputs of test_chain_plain_vs_jax):
    # there every f32 summation order but the plain one's own, the correctly
    # rounded f64 sum included, moves some of the many elements the chain
    # changes by an ulp, so the chain is held step by step instead: each
    # product of the split arithmetic within the f32 rounding of its sum
    # (4 ulps of the sum of |terms|) of the exact product in f64
    e, c = _chain_inputs(50, 64, tiny_frac=0.25)
    hi, mid, lo = (p.float() for p in tprobe.bf16_split(c))
    ef = e.to(torch.bfloat16).float()
    cross = (ef @ hi.T + ef @ mid.T) + ef @ lo.T
    exact = ef.double() @ c.double().T
    tol = 4 * 2.0 ** -24 * (ef.abs().double() @ c.abs().double().T)
    assert bool(((cross.double() - exact).abs() <= tol).all())
    cb = cross.to(torch.bfloat16).float()
    upd = (cb @ hi + cb @ mid) + cb @ lo
    exact = cb.double() @ c.double()
    tol = 4 * 2.0 ** -24 * (cb.abs().double() @ c.abs().double())
    assert bool(((upd.double() - exact).abs() <= tol).all())
    # one bf16 part alone is not enough: c_hi's products miss by far more
    assert not bool((((ef @ hi.T).double() - ef.double() @ c.double().T).abs()
                     <= 4 * 2.0 ** -24 * (ef.abs().double() @ c.abs().double().T)).all())


STEP_MODELS = {"plain": tprobe.bf16_chain_plain, "split": tprobe.bf16_chain_split_model}


@pytest.mark.parametrize("model", list(STEP_MODELS))
@pytest.mark.parametrize("seed,mb,tiny_frac", [(50, 64, 0.25), (0, 256, 0.0)])
def test_one_step_within_its_bounds(model, seed, mb, tiny_frac):
    e, c = _chain_inputs(seed, mb, tiny_frac)
    got = STEP_MODELS[model](e, c, 1)
    lo, hi = tprobe.bf16_step_bounds(e, c)
    assert bool(((got >= lo) & (got <= hi)).all())
    # the bounds pin nearly every element to one bf16 value
    assert float((lo == hi).float().mean()) > 0.99


@pytest.mark.parametrize("wrong", ["no step", "c_hi alone"])
def test_one_step_bounds_refuse_a_wrong_step(wrong):
    # on the tiny-element inputs, where a step changes most of those elements
    e, c = _chain_inputs(50, 64, tiny_frac=0.25)
    got = (e.to(torch.bfloat16).float() if wrong == "no step"
           else tprobe.bf16_chain_plain(e, c.to(torch.bfloat16).float(), 1))
    lo, hi = tprobe.bf16_step_bounds(e, c)
    assert float(((got >= lo) & (got <= hi)).float().mean()) < 0.99
