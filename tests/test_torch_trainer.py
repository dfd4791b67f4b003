"""The two-phase trainer: the port against the JAX package's trainer on the
same initial parameters, seed and batches (numpy), and the port's own
schedule, chunking and checkpoint behaviour.

The JAX trainer's kernel searches run in interpret mode (the module
attributes that ``losses.py`` imports at call time are patched).  Losses and
parameters are compared with the JAX trainer tests' own tolerances,
``rtol=2e-4, atol=2e-5``: the two frameworks take f32 sums in other orders
and Adam's update rounds differently (``sqrt(nu) / sqrt(bc2)`` in torch,
``sqrt(nu / bc2)`` in optax), while every search index agrees.
"""

import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu.ops import gramv3 as jg3
from quantization_tpu.ops import seqbeam as jseq
from quantization_tpu import core as jcore
from quantization_tpu.train.trainer import QuantizerTrainer as JTrainer
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.train.trainer import QuantizerTrainer
from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS, params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-5)


def _batches(n, B, dim, seed):
    """Frames with structure: a few Gaussian clusters plus noise."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((8, dim)).astype(np.float32)
    pick = rng.integers(0, 8, (n, B))
    return (means[pick] + 0.3 * rng.standard_normal((n, B, dim))).astype(np.float32)


def _port_like(jt, **kw):
    """A port trainer with the JAX trainer's seed, settings and initial
    parameters (the host RNG draws the same numbers from here on)."""
    tt = QuantizerTrainer(device="cpu", **kw)
    params = params_from_numpy({f: np.asarray(getattr(jt.params, f)) for f in PARAM_FIELDS})
    with torch.no_grad():
        for f in PARAM_FIELDS:
            getattr(tt.params, f).copy_(getattr(params, f))
    return tt


def _assert_params_close(tt, jt, **tol):
    assert tt.config.codebook_size == jt.config.codebook_size
    assert tt.config.num_codebooks == jt.config.num_codebooks
    for f in PARAM_FIELDS:
        got = getattr(tt.params, f).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jt.params, f)).reshape(got.shape),
                                   err_msg=f, **(tol or TOL))


def _next_iters(trainer):
    """The refinement iterations the trainer's next ``step`` will draw."""
    rng = np.random.default_rng()
    rng.bit_generator.state = trainer._rng.bit_generator.state
    return 2 if rng.random() < trainer.two_iter_prob else 1


def _track(jt, tt, batches):
    """Step both trainers; each step's port losses against the JAX losses at
    the same parameters, refinement iterations and search."""
    for x in batches:
        n = _next_iters(jt)
        assert n == _next_iters(tt)
        jl = jcore.compute_loss(jt.params, jt.config, jnp.asarray(x), n,
                                search_method=jt._search_for_config(jt.cur_iter))
        assert tt._search_for_config(tt.cur_iter) == jt._search_for_config(jt.cur_iter)
        tl = tt.step(x)
        jt.step(x)
        for name, want in jl._asdict().items():
            np.testing.assert_allclose(float(getattr(tl, name)), float(want), err_msg=name, **TOL)
    assert _rng_state(tt) == _rng_state(jt)


def _rng_state(trainer):
    # the PCG64 state and increment, which checkpoints carry (not the
    # buffered 32-bit half, which doubles do not use)
    return trainer._rng.bit_generator.state["state"]


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jg3, "gramv3_encode_indexes",
                        functools.partial(jg3.gramv3_encode_indexes, interpret=True))
    monkeypatch.setattr(jseq, "seqbeam_encode_indexes",
                        functools.partial(jseq.seqbeam_encode_indexes, interpret=True))


def test_lr_schedule_matches_steplr():
    t = QuantizerTrainer(dim=16, bytes_per_frame=2, phase_one_iters=100, phase_two_iters=200,
                         lr=0.004, seed=0, diagnostics=False, device="cpu")
    j = JTrainer(dim=16, bytes_per_frame=2, phase_one_iters=100, phase_two_iters=200,
                 lr=0.004, seed=0, diagnostics=False)
    assert t._lr_for_iter(0) == 0.004
    assert t._lr_for_iter(24) == 0.004
    assert t._lr_for_iter(25) == 0.002
    assert t._lr_for_iter(99) == 0.0005
    assert t._lr_for_iter(100) == 0.004 * 0.5 ** 4  # last phase-1 step
    assert t._lr_for_iter(101) == 0.002  # phase 2: base halved
    assert t._lr_for_iter(150) == 0.002
    assert t._lr_for_iter(151) == 0.001
    assert t._lr_for_iter(300) == 0.002 * 0.5 ** 3
    assert [t._lr_for_iter(i) for i in range(302)] == [j._lr_for_iter(i) for i in range(302)]


def test_finetune_boundary_defaults_and_checkpoint_meta(monkeypatch, tmp_path):
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=10, phase_two_iters=10, seed=0,
              diagnostics=False, device="cpu")
    assert QuantizerTrainer(**kw).beam_finetune_iters == 0
    assert QuantizerTrainer(**kw, train_search="beam").beam_finetune_iters == 0
    assert QuantizerTrainer(**kw, train_search="gramv3").beam_finetune_iters == 10  # 1000, clamped
    assert QuantizerTrainer(**kw, train_search="seqbeam", beam_finetune_iters=7).beam_finetune_iters == 7
    t = QuantizerTrainer(**kw, train_search="seqbeam", beam_finetune_iters=99)
    assert t.beam_finetune_iters == 10
    tr = QuantizerTrainer(**kw, train_search="seqbeam", beam_finetune_iters=5)
    assert tr._search_for_config(3) == "beam"  # phase 1: cs=16, no kernel applies
    monkeypatch.setattr(tseq, "SEQBEAM_SUPPORTED", lambda cfg: True)
    assert tr._finetune_start() == 16
    assert tr._search_for_config(15) == "seqbeam"
    assert tr._search_for_config(16) == "beam"
    assert tr._search_for_config(20) == "beam"
    g = QuantizerTrainer(**kw, train_search="gramv3-int8", beam_finetune_iters=0)
    monkeypatch.setattr(tg3, "GRAMV3_SUPPORTED", lambda cfg: True)
    assert g._search_for_config(20) == "gramv3-int8"

    path = tmp_path / "ckpt.npz"
    t.save_checkpoint(path)
    t2 = QuantizerTrainer.load_checkpoint(path, diagnostics=False, device="cpu")
    assert t2.train_search == "seqbeam" and t2.beam_finetune_iters == 10
    t3 = QuantizerTrainer.load_checkpoint(path, diagnostics=False, device="cpu",
                                          train_search="beam", beam_finetune_iters=0)
    assert t3.train_search == "beam" and t3.beam_finetune_iters == 0


def test_get_quantizer_asserts_before_done_and_unported_options_raise(monkeypatch):
    t = QuantizerTrainer(dim=16, bytes_per_frame=1, phase_one_iters=5, phase_two_iters=5,
                         seed=0, diagnostics=False, device="cpu")
    with pytest.raises(AssertionError):
        t.get_quantizer()
    assert qtt.QuantizerTrainer is QuantizerTrainer  # exported lazily
    # mesh= is ported: a 1 x 1 mesh trains; a larger one needs a process group
    from quantization_tpu_torch.parallel import make_mesh

    assert QuantizerTrainer(16, 1, seed=0, mesh=make_mesh(device="cpu")).device.type == "cpu"
    with pytest.raises(ValueError, match="init_distributed"):
        make_mesh(num_data=2, device="cpu")
    with pytest.raises(ValueError):
        QuantizerTrainer(16, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantizerTrainer(16, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_beam_schedule_tracks_jax():
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=12, phase_two_iters=12, lr=0.01,
              seed=3, diagnostics=False)
    jt = JTrainer(**kw)
    tt = _port_like(jt, **kw)
    _track(jt, tt, _batches(25, 64, 16, 1))
    assert jt.done() and tt.done()
    _assert_params_close(tt, jt)
    q = tt.get_quantizer()
    assert (q.codebook_size, q.num_codebooks) == (256, 1)
    assert q.encode(torch.from_numpy(_batches(1, 32, 16, 2)[0])).shape == (32, 1)


def test_gramv3_phase_two_tracks_jax(interpret_kernels):
    kw = dict(dim=128, bytes_per_frame=2, phase_one_iters=2, phase_two_iters=4, lr=0.01,
              seed=5, diagnostics=False, train_search="gramv3", beam_finetune_iters=0)
    jt = JTrainer(**kw)
    tt = _port_like(jt, **kw)
    launches = tg3.GRAMV3_KERNEL.launches
    batches = _batches(6, 64, 128, 4)
    _track(jt, tt, batches[:3])
    assert (tt.config.codebook_size, tt.config.num_codebooks) == (256, 2)
    assert tt._search_for_config(tt.cur_iter) == "gramv3"
    _track(jt, tt, batches[3:])  # phase-2 steps through the Gram-table search
    _assert_params_close(tt, jt)
    assert tg3.GRAMV3_KERNEL.launches == launches  # CPU tensors: the plain version


def test_step_many_equals_the_step_loop():
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=10, phase_two_iters=10, lr=0.01,
              seed=7, diagnostics=False, device="cpu", beam_finetune_iters=4)
    t1, t2 = QuantizerTrainer(**kw), QuantizerTrainer(**kw)
    xs = _batches(22, 32, 16, 6)
    for x in xs:
        t1.step(x)
    pos = 0
    for chunk in (7, 9, 3, len(xs)):  # uneven chunks across both switches
        take = min(chunk, len(xs) - pos)
        if take:
            assert len(t2.step_many(xs[pos:pos + take])) == take
            pos += take
    assert t1.cur_iter == t2.cur_iter and t1.config == t2.config
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(t1.params, f), getattr(t2.params, f)), f
    # random(k) draws the k numbers of k random() calls
    assert _rng_state(t1) == _rng_state(t2)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=8, phase_two_iters=8, lr=0.01,
              seed=9, diagnostics=False, device="cpu")
    xs = _batches(17, 32, 16, 8)
    t1 = QuantizerTrainer(**kw)
    for x in xs[:11]:  # mid phase 2
        t1.step(x)
    path = tmp_path / "ckpt.npz"
    t1.save_checkpoint(path)
    t2 = QuantizerTrainer.load_checkpoint(path, diagnostics=False, device="cpu")
    assert t2.cur_iter == 11 and t2.config == t1.config
    for x in xs[11:]:
        t1.step(x)
        t2.step(x)
    assert t1.done() and t2.done()
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(t1.params, f), getattr(t2.params, f)), f
    # the JAX package reads the port's checkpoint
    back = JTrainer.load_checkpoint(path, diagnostics=False)
    assert back.cur_iter == 11 and back.config.codebook_size == 256


def test_jax_checkpoint_continues_to_jax_params(tmp_path):
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=6, phase_two_iters=8, lr=0.01,
              seed=11, diagnostics=False)
    xs = _batches(15, 64, 16, 10)
    jt = JTrainer(**kw)
    for x in xs[:9]:  # mid phase 2, with Adam moments in flight
        jt.step(x)
    path = tmp_path / "jax_ckpt.npz"
    jt.save_checkpoint(path)
    tt = QuantizerTrainer.load_checkpoint(path, diagnostics=False, device="cpu")
    assert tt.cur_iter == 9 and _rng_state(tt) == _rng_state(jt)
    _assert_params_close(tt, jt, rtol=0, atol=0)  # loaded bit for bit
    _track(jt, tt, xs[9:])
    _assert_params_close(tt, jt)


def test_a_step_under_no_grad_still_trains():
    kw = dict(dim=16, bytes_per_frame=1, phase_one_iters=2, phase_two_iters=2, lr=0.01,
              seed=1, diagnostics=False, device="cpu")
    t1, t2 = QuantizerTrainer(**kw), QuantizerTrainer(**kw)
    x = _batches(1, 32, 16, 3)[0]
    t1.step(x)
    with torch.no_grad():
        t2.step(x)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(t1.params, f), getattr(t2.params, f)), f


def test_diagnostics_log_every_200_steps(caplog):
    t = QuantizerTrainer(dim=16, bytes_per_frame=1, phase_one_iters=2, phase_two_iters=2,
                         seed=0, device="cpu")  # diagnostics on by default
    xs = _batches(2, 32, 16, 4)
    with caplog.at_level(logging.INFO, logger="quantization_tpu_torch.train.trainer"):
        t.step(xs[0])  # iteration 0 logs the per-iteration losses
        t.step(xs[1])
    logged = [r.getMessage() for r in caplog.records if "loss_per_iter" in r.getMessage()]
    assert len(logged) == 1 and logged[0].startswith("phase=1/2, iter=0, dim,nc,csz=16,2,16")
