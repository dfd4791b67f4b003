"""The multi-kmeans prototype and its trainers: the port against the JAX
package on the CPU, the same parameters carried across by
``multi_kmeans_params_from_numpy`` and the same inputs made with numpy.

Sampling cannot follow ``jax.random.categorical`` draw for draw, so the
stochastic refinement is held by its losses and gradients on the same input
indexes, and its sampler by its distribution.  Tolerances, stated in each
test, are relative to the largest magnitude of the JAX value
(``max|port - jax| / max|jax|``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu.data.synthetic import make_mlp_sampler
from quantization_tpu.models import multi_kmeans as jmk
from quantization_tpu.train import multi_kmeans_trainer as jmkt
from quantization_tpu.train.trainer import QuantizerTrainer as JTrainer
from quantization_tpu_torch.models import multi_kmeans as tmk
from quantization_tpu_torch.train import multi_kmeans_trainer as tmkt
from quantization_tpu_torch.train.trainer import QuantizerTrainer
from quantization_tpu_torch.utils.torch_interop import multi_kmeans_params_from_numpy

SHAPES = [(16, 4, 8, 64), (64, 16, 4, 128)]  # (dim, cs, nc, B)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _setup(dim, cs, nc, B, seed=0):
    """The same centers, frames and input indexes on both sides."""
    rng = np.random.default_rng(seed)
    arrays = {"centers": (dim ** -0.5 * rng.standard_normal((nc, cs, dim))).astype(np.float32),
              "frame_entropy_scale": np.float32(0.03)}
    x = rng.standard_normal((B, dim)).astype(np.float32)
    idx = rng.integers(0, cs, (B, nc)).astype(np.int32)
    jp = jmk.MultiKmeansParams(centers=jnp.asarray(arrays["centers"]),
                               frame_entropy_scale=jnp.asarray(arrays["frame_entropy_scale"]))
    return jp, multi_kmeans_params_from_numpy(arrays), x, idx


@pytest.mark.parametrize("dim,cs,nc,B", SHAPES)
def test_refine_indexes_equals_jax_and_the_brute_force_argmin(dim, cs, nc, B):
    jp, tp, x, idx = _setup(dim, cs, nc, B)
    got = tmk.refine_indexes(tp, torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmk.refine_indexes(jp, jnp.asarray(x), idx)))
    # the defining property (tests/test_multi_kmeans.py:18-35): per codebook
    # the argmin of the squared error with the others held at their input
    c = np.asarray(jp.centers, np.float64)
    old = c[np.arange(nc)[None, :], idx]  # (B, nc, dim)
    x_err = old.sum(1) - x
    mod = x_err[:, None, None, :] - old[:, :, None, :] + c[None]  # (B, nc, cs, dim)
    np.testing.assert_array_equal(got, (mod ** 2).sum(-1).argmin(2))
    assert got.dtype == np.int32


@pytest.mark.parametrize("dim,cs,nc,B", SHAPES)
def test_encode_decode_product_params_and_ref_loss_match_jax(dim, cs, nc, B):
    jp, tp, x, _ = _setup(dim, cs, nc, B)
    tx = torch.from_numpy(x)
    for as_bytes in (False, True):
        got = tmk.encode(tp, tx, num_iters=3, as_bytes=as_bytes)
        want = np.asarray(jmk.encode(jp, jnp.asarray(x), num_iters=3, as_bytes=as_bytes))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
        # decode of the packed and of the plain codes, within 1e-6
        assert _rel(tmk.decode(tp, got), jmk.decode(jp, jnp.asarray(want))) <= 1e-6
    grown_t, grown_j = tmk.product_params(tp), jmk.product_params(jp)
    assert _rel(grown_t.centers, grown_j.centers) <= 1e-6
    assert float(grown_t.frame_entropy_scale) == float(grown_j.frame_entropy_scale)
    # compute_ref_loss within 1e-5 relative
    assert _rel(tmk.compute_ref_loss(tp, tx), jmk.compute_ref_loss(jp, jnp.asarray(x))) <= 1e-5


def _total(out, entropy_scale, target):
    return (out.reconstruction_loss + entropy_scale * out.entropy_loss
            + abs(out.frame_entropy - target))


@pytest.mark.parametrize("dim,cs,nc,B", SHAPES)
def test_stochastic_refine_losses_and_gradients_match_jax(dim, cs, nc, B):
    """On the same input indexes: the three losses within 1e-5 relative, the
    gradients of the trainer's total loss within 1e-4 relative."""
    jp, tp, x, idx = _setup(dim, cs, nc, B)
    es, target = 0.1, 0.5  # a visible entropy term, so that its gradient counts
    leaves = tmk.MultiKmeansParams(tp.centers.clone().requires_grad_(True),
                                   tp.frame_entropy_scale.clone().requires_grad_(True))
    out = tmk.refine_indexes_stochastic(leaves, torch.from_numpy(x), torch.from_numpy(idx),
                                        torch.Generator().manual_seed(0))
    _total(out, es, target).backward()

    def jloss(p):
        o = jmk.refine_indexes_stochastic(p, jnp.asarray(x), jnp.asarray(idx),
                                          jax.random.PRNGKey(0))
        return _total(o, es, target), o

    # the losses from an eager call, as the JAX tests make it (jit reorders
    # the sums, and entropy_loss is log(cs) less a nearly equal entropy);
    # the gradients jitted
    _, jout = jloss(jp)
    jgrad, _ = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    for name in ("reconstruction_loss", "entropy_loss", "frame_entropy"):
        assert _rel(float(getattr(out, name).detach()), float(getattr(jout, name))) <= 1e-5, name
    assert _rel(leaves.centers.grad, jgrad.centers) <= 1e-4
    assert _rel(float(leaves.frame_entropy_scale.grad), float(jgrad.frame_entropy_scale)) <= 1e-4
    assert out.indexes.shape == (B, nc) and out.indexes.dtype == torch.int32


def test_stochastic_refine_gradient_routing():
    """frame_entropy's gradient reaches frame_entropy_scale only, the
    reconstruction loss's the centers only (tests/test_multi_kmeans.py:64-81)."""
    _, tp, x, _ = _setup(16, 4, 8, 64)
    idx = torch.zeros(64, 8, dtype=torch.int32)
    for term, flows, blocked in (("frame_entropy", 1, 0), ("reconstruction_loss", 0, 1)):
        leaves = [tp.centers.clone().requires_grad_(True),
                  tp.frame_entropy_scale.clone().requires_grad_(True)]
        out = tmk.refine_indexes_stochastic(tmk.MultiKmeansParams(*leaves), torch.from_numpy(x),
                                            idx, torch.Generator().manual_seed(5))
        grads = torch.autograd.grad(getattr(out, term), leaves, allow_unused=True)
        assert grads[flows] is not None and float(grads[flows].abs().max()) > 0, term
        assert grads[blocked] is None or float(grads[blocked].abs().max()) == 0, term


def test_sampler_follows_softmax_and_forward_init_skips_the_last_entry(monkeypatch):
    """20,000 draws from a fixed table: each entry's frequency within 5
    standard errors of softmax; no index reaches cs."""
    n, cs = 20000, 8
    table = torch.tensor([[0.0, 1.0, 2.0, -1.0, 0.5, -3.0, 1.5, -20.0],
                          [3.0, 3.0, 0.0, 0.0, -1.0, 2.5, 1.0, 0.2]])
    logprobs = torch.log_softmax(table, dim=-1)
    draws = tmk.sample_categorical(logprobs.expand(n, 2, cs).contiguous(),
                                   torch.Generator().manual_seed(0))
    assert draws.dtype == torch.int32 and int(draws.min()) >= 0 and int(draws.max()) < cs
    p = logprobs.exp().numpy()
    for row in range(2):
        freq = np.bincount(draws[:, row].numpy(), minlength=cs) / n
        se = np.sqrt(p[row] * (1 - p[row]) / n)
        assert np.all(np.abs(freq - p[row]) <= 5 * se + 1e-12), (row, freq, p[row])

    # forward's initial draw excludes cs - 1; later samples may take it
    seen = []
    real = tmk.refine_indexes_stochastic

    def record(params, x, indexes, generator):
        seen.append(indexes.clone())
        return real(params, x, indexes, generator)

    monkeypatch.setattr(tmk, "refine_indexes_stochastic", record)
    _, tp, _, _ = _setup(16, 4, 8, 64)
    x = torch.zeros(4096, 16)  # every entry nearly equally likely at scale 1
    tp.frame_entropy_scale.fill_(-1.0)
    tmk.forward(tp, x, torch.Generator().manual_seed(1), num_iters=2)
    assert int(seen[0].max()) == 4 - 2 and int(seen[0].min()) == 0
    assert int(seen[1].max()) == 4 - 1


def test_trainer_update_equals_the_optax_chain():
    """Three updates given the same gradients: the trainer's optimiser
    against add_decayed_weights(1e-6) + scale_by_adam(0.9, 0.9, 1e-9), within
    1e-6 relative."""
    jp, tp, _, _ = _setup(16, 4, 8, 64)
    rng = np.random.default_rng(3)
    leaves = tmk.MultiKmeansParams(tp.centers.clone().requires_grad_(True),
                                   tp.frame_entropy_scale.clone().requires_grad_(True))
    opt = tmkt.make_optimizer(leaves)
    tx = jmkt._make_tx()
    state = tx.init(jp)
    for lr in (1e-3, 1e-3, 5e-4):
        g = {"centers": rng.standard_normal(jp.centers.shape).astype(np.float32),
             "frame_entropy_scale": np.float32(rng.standard_normal())}
        leaves.centers.grad = torch.from_numpy(g["centers"])
        leaves.frame_entropy_scale.grad = torch.tensor(g["frame_entropy_scale"])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        grads = jmk.MultiKmeansParams(centers=jnp.asarray(g["centers"]),
                                      frame_entropy_scale=jnp.asarray(g["frame_entropy_scale"]))
        updates, state = tx.update(grads, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p - lr * u, jp, updates)
    assert _rel(leaves.centers.detach(), jp.centers) <= 1e-6
    assert _rel(float(leaves.frame_entropy_scale), float(jp.frame_entropy_scale)) <= 1e-6


def test_trainer_schedule_matches_jax():
    kw = dict(dim=16, codebook_size=4, num_codebooks=4, num_stages=3, iters_per_stage=3000,
              lr=0.002, target_frame_entropy=0.3, seed=0)
    tt = tmkt.MultiKmeansTrainer(device="cpu", **kw)
    jt = jmkt.MultiKmeansTrainer(**kw)
    for stage, it in ((0, 0), (0, 999), (0, 1000), (1, 0), (1, 2500)):
        tt.stage = jt.stage = stage
        tt.iter_in_stage = jt.iter_in_stage = it
        assert tt._lr_now() == pytest.approx(jt._lr_now(), rel=1e-12)
        assert tt._target_now() == pytest.approx(jt.target_frame_entropy * 1.5 ** stage,
                                                 rel=1e-12)


def test_staged_trainer_learns():
    """A port of tests/test_multi_kmeans.py::test_staged_trainer_learns on
    the same frames (the JAX package's MLP sampler)."""
    dim = 16
    sampler = make_mlp_sampler(dim, jax.random.PRNGKey(0))
    x_eval = np.array(sampler(jax.random.PRNGKey(1), 512))
    batches = np.array(sampler(jax.random.PRNGKey(2), 160 * 256)).reshape(160, 256, dim)
    trainer = tmkt.MultiKmeansTrainer(dim=dim, codebook_size=4, num_codebooks=4, num_stages=2,
                                      iters_per_stage=80, lr=0.003, seed=0, device="cpu")
    err0 = float(trainer.get_quantizer().compute_ref_loss(x_eval))
    i = 0
    while not trainer.done():
        out = trainer.step(batches[i])
        assert all(bool(torch.isfinite(v).all()) for v in out[1:])
        i += 1
    assert i == 160
    q = trainer.get_quantizer()
    # grew once: cs 4 -> 16, nc 4 -> 2
    assert (q.codebook_size, q.num_codebooks) == (16, 2)
    assert q.centers.shape == (2, 16, dim)
    err1 = float(q.compute_ref_loss(x_eval))
    assert err1 < err0 * 0.9, (err0, err1)


def test_product_growth_preserves_decode():
    _, tp, _, _ = _setup(16, 4, 4, 10)
    grown = tmk.product_params(tp)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (10, 4)).astype(np.int32))
    torch.testing.assert_close(tmk.decode(grown, idx[:, 0::2] * 4 + idx[:, 1::2]),
                               tmk.decode(tp, idx), rtol=1e-5, atol=1e-6)


def test_quantizer_trainer_multi_kmeans_init_follows_jax_and_trains():
    """init='multi_kmeans': to_logits_w equals the fitted centers in its own
    storage, the host RNG stands where the JAX trainer's stands after
    construction, and the trainer trains to done() and encodes (a port of
    tests/test_trainer.py:239-259)."""
    dim = 16
    sampler = make_mlp_sampler(dim, jax.random.PRNGKey(5))
    data = np.array(sampler(jax.random.PRNGKey(6), 512))
    kw = dict(dim=dim, bytes_per_frame=1, phase_one_iters=5, phase_two_iters=5, seed=7,
              diagnostics=False, init="multi_kmeans", init_data=data, init_iters=10)
    t = QuantizerTrainer(device="cpu", **kw)
    jt = JTrainer(**kw)
    assert t._rng.bit_generator.state == jt._rng.bit_generator.state
    w, c = t.params.to_logits_w, t.params.centers
    assert torch.equal(w, c.reshape(-1, dim)) and w.data_ptr() != c.data_ptr()
    assert w.is_leaf and c.is_leaf
    # the bias is init_quantizer_params's bias for the same seed
    t0 = QuantizerTrainer(device="cpu", **{**kw, "init": "default", "init_data": None})
    assert torch.equal(t.params.to_logits_b, t0.params.to_logits_b)
    # the fitted centers are nearer the data than the fit's random start
    start = np.random.default_rng(7)
    start.integers(0, 2**31)  # the parameters' seed
    fit = tmkt.MultiKmeansTrainer(dim, 16, 2, num_stages=1, iters_per_stage=10,
                                  seed=int(start.integers(0, 2**31)), device="cpu")
    fitted = tmk.MultiKmeansParams(c.detach(), torch.zeros(()))
    assert float(tmk.compute_ref_loss(fitted, torch.from_numpy(data))) < float(
        fit.get_quantizer().compute_ref_loss(data))
    x = np.array(sampler(jax.random.PRNGKey(8), 64))
    while not t.done():
        losses = t.step(x)
        assert all(bool(torch.isfinite(v)) for v in losses)
    q = t.get_quantizer()
    assert q.encode(torch.from_numpy(data)).shape == (512, 1)


def test_init_multi_kmeans_refuses_a_missing_init_data():
    with pytest.raises(ValueError, match="init_data"):
        QuantizerTrainer(16, 1, device="cpu", init="multi_kmeans")
    with pytest.raises(ValueError, match="unknown init"):
        QuantizerTrainer(16, 1, device="cpu", init="kmeans")


def test_module_surface_and_exports():
    assert qtt.train.MultiKmeansTrainer is tmkt.MultiKmeansTrainer
    q = tmk.MultiKmeansQuantizer(16, 4, 8, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    x = np.random.default_rng(0).standard_normal((32, 16))  # float64 in, float32 used
    codes = q.encode(x, as_bytes=True)
    assert codes.dtype == torch.uint8 and codes.shape == (32, 2)
    torch.testing.assert_close(q.decode(codes), q.decode(q.encode(x)), rtol=0, atol=0)
    out = q(x, torch.Generator().manual_seed(1))
    assert out.indexes.shape == (32, 8)
    g = q.get_product_quantizer()
    assert (g.codebook_size, g.num_codebooks) == (16, 4) and g.device == q.device
