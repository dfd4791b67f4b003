"""The joint codebook predictor, its trainer and gradient checkpointing: the
port against the JAX package on the CPU, the same parameters carried across
by ``joint_codebook_params_from_numpy`` and the same inputs made with numpy.
Tolerances, stated in each test, are relative to the largest magnitude of
the JAX value (``max|port - jax| / max|jax|``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu.models import prediction as jpred
from quantization_tpu.models.quantizer import Quantizer as JQuantizer
from quantization_tpu.train.predictor_trainer import PredictorTrainer as JPredictorTrainer
from quantization_tpu_torch.models import prediction as tpred
from quantization_tpu_torch.train.predictor_trainer import PredictorTrainer
from quantization_tpu_torch.utils.torch_interop import (
    PARAM_FIELDS,
    joint_codebook_params_from_numpy,
    params_from_numpy,
)

FIELDS = tpred.JOINT_CODEBOOK_FIELDS


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arrays(rng, P, nc, cs, hidden):
    """Parameters with the init's scales and a nonzero bias."""
    return {
        "linear1_w": rng.uniform(-P ** -0.5, P ** -0.5, (hidden, P)),
        "linear1_b": rng.uniform(-P ** -0.5, P ** -0.5, hidden),
        "embedding": rng.standard_normal(((nc - 1) * cs, hidden)) * hidden ** -0.5,
        "linear2_w": rng.standard_normal((nc, cs, hidden)) * hidden ** -0.5,
        "linear2b_w": rng.standard_normal((nc, cs, P)) * P ** -0.5,
        "linear2_b": 0.1 * rng.standard_normal((nc, cs)),
    }


def _setup(N=32, P=24, nc=4, cs=8, hidden=16, pad=8, seed=0):
    """Both sides' parameters, the features and indexes; the last ``pad``
    rows are padding (-100 in every codebook, the reference's contract)."""
    rng = np.random.default_rng(seed)
    arrays = {k: v.astype(np.float32) for k, v in _arrays(rng, P, nc, cs, hidden).items()}
    pred = rng.standard_normal((N, P)).astype(np.float32)
    idx = rng.integers(0, cs, (N, nc)).astype(np.int32)
    idx[N - pad:] = -100
    jp = jpred.JointCodebookParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jp, joint_codebook_params_from_numpy(arrays), pred, idx


def _leaves(tp):
    return tpred.JointCodebookParams(
        **{f: getattr(tp, f).clone().requires_grad_(True) for f in FIELDS})


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_logits_and_loss_match_jax(reduction):
    """Logits and the loss on rows with -100 padding, within 1e-5 relative."""
    jp, tp, pred, idx = _setup()
    got = tpred.joint_codebook_logits(tp, torch.from_numpy(pred), torch.from_numpy(idx))
    assert _rel(got, jpred.joint_codebook_logits(jp, jnp.asarray(pred), jnp.asarray(idx))) <= 1e-5
    loss = tpred.joint_codebook_loss(tp, torch.from_numpy(pred), torch.from_numpy(idx),
                                     reduction=reduction)
    want = jpred.joint_codebook_loss(jp, jnp.asarray(pred), jnp.asarray(idx), reduction=reduction)
    assert loss.shape == want.shape
    assert _rel(loss, want) <= 1e-5
    if reduction == "none":
        assert float(loss[-8:].abs().max()) == 0.0  # padding rows contribute nothing


def test_unknown_reduction_and_mismatched_shapes_raise():
    _, tp, pred, idx = _setup()
    with pytest.raises(ValueError, match="reduction"):
        tpred.joint_codebook_loss(tp, torch.from_numpy(pred), torch.from_numpy(idx),
                                  reduction="max")
    with pytest.raises(ValueError, match="leading shape"):
        tpred.joint_codebook_loss(tp, torch.from_numpy(pred), torch.from_numpy(idx[:-1]))
    bad = {f: getattr(tp, f).numpy() for f in FIELDS}
    bad["linear2b_w"] = bad["linear2b_w"][:, :, :-1]
    with pytest.raises(ValueError, match="linear2b_w"):
        joint_codebook_params_from_numpy(bad)


def test_gradients_match_jax():
    """Gradients of the summed loss with padding, within 1e-4 relative."""
    jp, tp, pred, idx = _setup()
    leaves = _leaves(tp)
    tpred.joint_codebook_loss(leaves, torch.from_numpy(pred), torch.from_numpy(idx)).backward()
    jg = jax.jit(jax.grad(jpred.joint_codebook_loss))(jp, jnp.asarray(pred), jnp.asarray(idx))
    for f in FIELDS:
        assert _rel(getattr(leaves, f).grad, getattr(jg, f)) <= 1e-4, f


def _grads(loss_of_params, tp):
    leaves = _leaves(tp)
    loss_of_params(leaves).backward()
    return {f: getattr(leaves, f).grad for f in FIELDS}


def test_checkpoint_gives_the_plain_gradients_to_every_parameter():
    """With features and indexes that do not require grad, the checkpointed
    loss (the module's ``checkpoint=True``, ``checkpoint``, ``remat``) gives
    every parameter the plain loss's gradient, nonzero (a reentrant
    checkpoint would give them none)."""
    _, tp, pred, idx = _setup(pad=0)
    pred_t, idx_t = torch.from_numpy(pred), torch.from_numpy(idx)
    plain = _grads(lambda p: tpred.joint_codebook_loss(p, pred_t, idx_t), tp)
    modules = {c: tpred.JointCodebookLoss(24, 4, 16, 8, checkpoint=c, params=tp, device="cpu")
               for c in (True, False)}
    for m in modules.values():
        m(pred_t, idx_t).backward()
    variants = {
        "module checkpoint=True": {f: getattr(modules[True], f).grad for f in FIELDS},
        "module checkpoint=False": {f: getattr(modules[False], f).grad for f in FIELDS},
        "checkpoint": _grads(lambda p: qtt.checkpoint(tpred.joint_codebook_loss, p, pred_t,
                                                      idx_t), tp),
        "remat": _grads(lambda p: qtt.remat(tpred.joint_codebook_loss)(p, pred_t, idx_t), tp),
    }
    for name, grads in variants.items():
        for f in FIELDS:
            assert grads[f] is not None and float(grads[f].abs().max()) > 0, (name, f)
            torch.testing.assert_close(grads[f], plain[f], rtol=1e-6, atol=0, msg=f"{name} {f}")


def test_joint_dependency_on_previous_codebooks():
    """Changing codebook 0's index changes the logits of codebooks >= 1 but
    not codebook 0's own (tests/test_prediction.py:54-65)."""
    _, tp, pred, idx = _setup(pad=0)
    a = tpred.joint_codebook_logits(tp, torch.from_numpy(pred), torch.from_numpy(idx))
    idx_b = idx.copy()
    idx_b[:, 0] = (idx_b[:, 0] + 1) % 8
    b = tpred.joint_codebook_logits(tp, torch.from_numpy(pred), torch.from_numpy(idx_b))
    torch.testing.assert_close(a[:, 0], b[:, 0], rtol=1e-5, atol=0)
    assert float((a[:, 1:] - b[:, 1:]).abs().max()) > 1e-4


def test_last_codebook_not_used_as_input():
    _, tp, pred, idx = _setup(pad=0)
    idx_b = idx.copy()
    idx_b[:, -1] = (idx_b[:, -1] + 3) % 8
    torch.testing.assert_close(
        tpred.joint_codebook_logits(tp, torch.from_numpy(pred), torch.from_numpy(idx)),
        tpred.joint_codebook_logits(tp, torch.from_numpy(pred), torch.from_numpy(idx_b)),
        rtol=1e-5, atol=0)


def test_module_wrapper_and_training_progress():
    """Indexes that are a linear function of the features become much more
    predictable (tests/test_prediction.py:96-131)."""
    nc, cs, P = 4, 8, 24
    module = tpred.JointCodebookLoss(P, nc, hidden_channels=32, codebook_size=cs,
                                     generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((nc, P, cs)).astype(np.float32))

    def make_batch(N=256):
        pred = torch.from_numpy(rng.standard_normal((N, P)).astype(np.float32))
        return pred, torch.einsum("bp,npk->bnk", pred, w).argmax(-1).to(torch.int32)

    opt = torch.optim.Adam(module.parameters(), lr=3e-3)
    pred0, idx0 = make_batch()
    with torch.no_grad():
        loss0 = float(module(pred0, idx0)) / idx0.numel()
    for _ in range(150):
        opt.zero_grad()
        module(*make_batch()).backward()
        opt.step()
    with torch.no_grad():
        loss1 = float(module(pred0, idx0)) / idx0.numel()
    assert loss1 < loss0 * 0.8, (loss0, loss1)


def _quantizers(dim, nc, cs):
    jq = JQuantizer(dim=dim, codebook_size=cs, num_codebooks=nc, key=jax.random.PRNGKey(0))
    tq = qtt.Quantizer(dim, cs, nc, device="cpu", params=params_from_numpy(
        {f: np.asarray(getattr(jq.params, f)) for f in PARAM_FIELDS}))
    return jq, tq


def test_predictor_trainer_follows_jax():
    """Five steps from the same parameters and frames (noise 0, one
    refinement: the beam on both sides) at the default lr: each loss and
    the final parameters within 1e-4 relative.  (At lr 1e-2 the two sides'
    f32 rounding, 1e-7 in the parameters, moves one pre-ReLU value across 0
    in the fifth step, and Adam's normalised update turns that one row into
    a 1e-3 difference in the entries it dominates.)"""
    dim, nc, cs = 16, 4, 8
    jq, tq = _quantizers(dim, nc, cs)
    kw = dict(predictor_channels=dim, hidden_channels=32, num_iters=5, seed=1,
              encode_refine_iters=1)
    jt, tt = JPredictorTrainer(jq, **kw), PredictorTrainer(tq, **kw)
    arrays = {k: v.astype(np.float32)
              for k, v in _arrays(np.random.default_rng(2), dim, nc, cs, 32).items()}
    jt.params = jpred.JointCodebookParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with torch.no_grad():
        for f, v in vars(joint_codebook_params_from_numpy(arrays)).items():
            getattr(tt.params, f).copy_(v)
    frames = np.random.default_rng(3).standard_normal((5, 128, dim)).astype(np.float32)
    for x in frames:
        assert _rel(tt.step(x), jt.step(jnp.asarray(x))) <= 1e-4
    assert tt.done() and jt.done()
    for f in FIELDS:
        assert _rel(getattr(tt.params, f).detach(), getattr(jt.params, f)) <= 1e-4, f


def test_predictor_trainer_workflow():
    """tests/test_prediction.py::test_predictor_trainer_workflow: the CE a
    frame drops below 0.8 x the uniform distribution's."""
    dim, nc, cs = 16, 4, 8
    q = qtt.Quantizer(dim, cs, nc, generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = PredictorTrainer(q, predictor_channels=dim, hidden_channels=32, num_iters=60,
                               lr=1e-2, seed=1, encode_refine_iters=1)
    gen = torch.Generator().manual_seed(2)
    losses = []
    while not trainer.done():
        losses.append(trainer.step(torch.randn(128, dim, generator=gen)))
    assert losses[-1] < losses[0]
    assert losses[-1] < 0.8 * nc * math.log(cs)
    mod = trainer.get_predictor()
    assert isinstance(mod, qtt.JointCodebookLoss) and mod.checkpoint
    x = torch.randn(64, dim, generator=gen)
    out = mod(x, q.encode(x, refine_indexes_iters=1, as_bytes=False))
    assert out.shape == () and bool(torch.isfinite(out))


def test_noise_draws_come_from_the_trainer_seed():
    """With noise_level > 0 the targets come from noised frames drawn on the
    trainer's device generator: equal seeds give equal steps."""
    dim, nc, cs = 16, 4, 8
    q = qtt.Quantizer(dim, cs, nc, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(64, dim, generator=torch.Generator().manual_seed(1))
    kw = dict(predictor_channels=dim, hidden_channels=16, encode_refine_iters=1,
              noise_level=0.5)
    a, b, c = (PredictorTrainer(q, seed=s, **kw) for s in (4, 4, 5))
    with torch.no_grad():  # c differs from a in its noise only
        for f in FIELDS:
            getattr(c.params, f).copy_(getattr(a.params, f))
    la = a.step(x)
    assert la == b.step(x) != c.step(x)


def test_exports():
    from quantization_tpu_torch import train, utils

    assert qtt.JointCodebookLoss is tpred.JointCodebookLoss
    assert qtt.checkpoint is utils.checkpoint and qtt.remat is utils.remat
    assert train.PredictorTrainer is PredictorTrainer
    assert {"JointCodebookLoss", "checkpoint", "remat"} <= set(qtt.__all__)
    assert {"PredictorTrainer", "MultiKmeansTrainer", "make_optimizer",
            "total_loss"} <= set(train.__all__)
