"""Multi-device runs of the port on the CPU: ranks of a gloo process group.

The counterpart of ``tests/test_sharding.py``: data-parallel and
data x model runs must equal one process.  Each layout (2 x 1, 4 x 1 and
2 x 2) is one spawn of its ranks (``tests/torch_parallel_workers.py``,
which imports torch and the port only), shared by the cases below; the
one-process port, and the JAX package on its 8-device CPU mesh, run here.
Encode and decode are held bit for bit; the trainers at the tolerance of
``test_step_many_with_mesh_matches_single_device``, ``rtol=2e-4,
atol=2e-5``, which is also ``tests/test_torch_trainer.py``'s against the
JAX trainer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from quantization_tpu import core as jcore
from quantization_tpu.parallel import bulk as jbulk
from quantization_tpu.parallel import mesh as jmesh
from quantization_tpu.train.trainer import QuantizerTrainer as JTrainer
from quantization_tpu_torch.core import codec, search
from quantization_tpu_torch.core.types import QuantizerConfig
from quantization_tpu_torch.parallel import (
    decode_sharded,
    encode_sharded,
    gather_params,
    make_mesh,
    shard_params,
)
from quantization_tpu_torch.train.trainer import QuantizerTrainer
from quantization_tpu_torch.utils.torch_interop import PARAM_FIELDS, params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-5)
LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2), "2x1": (2, 1)}  # (num_data, num_model), in run order
CONFIG = (128, 256, 2)  # dim, codebook_size, num_codebooks: the seqbeam kernel's family
B = 102  # uneven over 4 ranks: padded to 104
SEARCHES = (  # name, search_method, refine_indexes_iters, kwargs
    ("auto", "auto", 2, {}),
    ("beam", "beam", 2, {}),
    ("cd", "cd", 2, {}),
    ("seqbeam", "seqbeam", 1, dict(M=8, R=4)),
)
# the phase switch inside step_many (5 + 5 steps, two of them by step), then
# a kernel search in phase 2 (gramv3's plain version on the CPU), which runs
# at full width on the gathered slices under a model axis
TRAINERS = {
    "beam": dict(dim=16, bytes_per_frame=1, phase_one_iters=5, phase_two_iters=5, lr=0.01,
                 seed=9),
    "gramv3": dict(dim=16, bytes_per_frame=2, phase_one_iters=3, phase_two_iters=3, lr=0.01,
                   seed=4, train_search="gramv3", beam_finetune_iters=0),
}
TRAIN_B = 64


def _frames(n, B, dim, seed):
    """Frames with structure: a few Gaussian clusters plus noise."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((8, dim)).astype(np.float32)
    pick = rng.integers(0, 8, (n, B))
    return (means[pick] + 0.3 * rng.standard_normal((n, B, dim))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inputs():
    config = jcore.QuantizerConfig(*CONFIG)
    params = {f: np.asarray(getattr(jcore.init_quantizer_params(jax.random.PRNGKey(0), config),
                                    f)) for f in PARAM_FIELDS}
    x = _frames(1, B, CONFIG[0], 1)[0]
    codes = codec.encode(params_from_numpy(params), QuantizerConfig(*CONFIG),
                         torch.from_numpy(x), 2).numpy()
    trainers = {}  # name -> (the JAX trainer's initial parameters, the global batches)
    for name, kw in TRAINERS.items():
        jt = JTrainer(diagnostics=False, **kw)
        steps = kw["phase_one_iters"] + kw["phase_two_iters"] + 1
        trainers[name] = ({f: np.asarray(getattr(jt.params, f)) for f in PARAM_FIELDS},
                          _frames(steps, TRAIN_B, kw["dim"], 7))
    return params, x, codes, trainers


def _drive(t, xs):
    """Drive a trainer as the workers drive theirs: two steps, then
    step_many across the phase switch; returns each step's loss terms and
    the first step's gradients."""
    x = torch.from_numpy(xs)
    losses = [t.step(x[0])]
    grads = {f: getattr(t.params, f).grad.clone() for f in PARAM_FIELDS}
    losses += [t.step(x[1])] + t.step_many(x[2:])
    return np.array([[float(v) for v in step] for step in losses]), grads


def _port_trainer(name, **kw):
    """A port trainer from the JAX trainer's initial parameters."""
    t = QuantizerTrainer(device="cpu", diagnostics=False, **TRAINERS[name], **kw)
    init = params_from_numpy(_inputs()[3][name][0])
    with torch.no_grad():
        for f in PARAM_FIELDS:
            getattr(t.params, f).copy_(getattr(init, f))
    return t


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The one-process port trainer after the run, its losses and its first
    step's gradients."""
    t = _port_trainer(name)
    return (t, *_drive(t, _inputs()[3][name][1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(layout)``: the layout's ranks' results.  One layout runs at a
    time (at most four ranks load the CPU); when one is collected the next
    starts, so that it runs while the cases read the last."""
    params, x, codes, trainers = _inputs()
    started, done = {}, {}

    def start(layout):
        nd, nm = LAYOUTS[layout]
        job = dict(
            config=CONFIG, params=params, x=x, codes=codes, searches=SEARCHES,
            trainers=[(name, dict(diagnostics=True, **TRAINERS[name]), init, xs)
                      for name, (init, xs) in trainers.items()],
            ckpt_dir=str(tmp_path_factory.mktemp(f"ckpt{layout}")))
        started[layout] = workers.start(nd * nm, nm, job)

    def get(layout):
        if layout not in done:
            if layout not in started:
                start(layout)
            done[layout] = workers.collect(started.pop(layout))
            later = [k for k in LAYOUTS if k not in done and k not in started]
            if later and not started:
                start(later[0])
        return done[layout]

    yield get
    for layout in list(started):  # a case failed before it read them
        try:
            workers.collect(started.pop(layout), timeout=0)
        except (RuntimeError, TimeoutError):
            pass


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_make_mesh_over_four_ranks(runs, layout):
    nd, nm = LAYOUTS[layout]
    grid = np.arange(4).reshape(nd, nm)
    for r, out in enumerate(runs(layout)):
        d, m = divmod(r, nm)
        assert out["rank"] == r
        assert out["shape"] == {"data": nd, "model": nm}
        assert out["coords"] == {"data": d, "model": m}
        assert out["members"] == {"data": grid[:, m].tolist(), "model": grid[d].tolist()}


@pytest.mark.parametrize("layout,search_name", [
    (layout, s[0]) for layout in LAYOUTS for s in SEARCHES
    if not (LAYOUTS[layout][1] > 1 and s[0] == "seqbeam")])  # raises on a model mesh (below)
def test_encode_sharded_matches_one_process(runs, layout, search_name):
    params, x, _, _ = _inputs()
    _, method, iters, kw = next(s for s in SEARCHES if s[0] == search_name)
    want = codec.encode(params_from_numpy(params), QuantizerConfig(*CONFIG), torch.from_numpy(x),
                        iters, search_method=method, **kw).numpy()
    for out in runs(layout):
        got = out["encode"][search_name]
        assert got.dtype == np.uint8 and got.shape == (B, 2)
        np.testing.assert_array_equal(got, want)


def test_kernel_search_on_model_mesh_raises(runs):
    for out in runs("2x2"):
        assert out["encode"]["seqbeam"].startswith("ValueError: search_method='seqbeam'")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_rank_encodes_only_its_rows(runs, layout):
    nd = LAYOUTS[layout][0]
    local = -(-B // nd)
    n_encodes = len(SEARCHES) - (layout == "2x2")  # the model mesh refuses the kernel first
    for out in runs(layout):
        assert out["rows"] == [local] * n_encodes


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_sharded_matches_one_process(runs, layout, use_kernel):
    params, _, codes, _ = _inputs()
    want = codec.decode(params_from_numpy(params), QuantizerConfig(*CONFIG),
                        torch.from_numpy(codes), use_kernel=use_kernel).numpy()
    for out in runs(layout):
        np.testing.assert_array_equal(out["decode"][use_kernel], want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encode_sharded_matches_jax_on_its_mesh(runs, layout):
    """The JAX encode_sharded on the 8-device CPU mesh (B=102 padded to
    104) against the port's on this layout, from the same parameters."""
    params, x, _, _ = _inputs()
    jparams = jcore.QuantizerParams(**{f: jnp.asarray(params[f]) for f in PARAM_FIELDS})
    want = np.asarray(jbulk.encode_sharded(jparams, jcore.QuantizerConfig(*CONFIG),
                                           jnp.asarray(x), jmesh.make_mesh(num_data=8),
                                           refine_indexes_iters=2))
    for out in runs(layout):
        np.testing.assert_array_equal(out["encode"]["auto"], want)


def _assert_params_close(got: dict, want, **tol):
    for f in PARAM_FIELDS:
        w = np.asarray(getattr(want, f).detach() if hasattr(want, f) else want[f])
        np.testing.assert_allclose(got[f], w.reshape(got[f].shape), err_msg=f, **(tol or TOL))


@pytest.mark.parametrize("trainer", list(TRAINERS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_trainer_matches_one_process(runs, layout, trainer):
    """step_many across the phase switch (and, for gramv3, the kernel
    search in phase 2) on the mesh against the one-process port trainer."""
    t = _one_process(trainer)[0]
    for out in runs(layout):
        res = out["train"][trainer]
        assert res["cur_iter"] == t.cur_iter
        _assert_params_close(res["params"], t.params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_trainer_matches_jax(runs, layout):
    for out in runs(layout):
        _assert_params_close(out["train"]["beam"]["params"], _jax_final())


@functools.lru_cache(maxsize=None)
def _jax_final():
    """The JAX trainer's parameters after the beam run (its seed gives the
    initial parameters the port's trainers copied)."""
    jt = JTrainer(diagnostics=False, **TRAINERS["beam"])
    xs = _inputs()[3]["beam"][1]
    for x in xs[:2]:
        jt.step(jnp.asarray(x))
    jt.step_many(jnp.asarray(xs[2:]))
    return {f: np.asarray(getattr(jt.params, f)) for f in PARAM_FIELDS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_losses_match_one_process(runs, layout):
    """Each step's four loss terms are the whole batch's."""
    for trainer in TRAINERS:
        want = _one_process(trainer)[1]
        for out in runs(layout):
            np.testing.assert_allclose(out["train"][trainer]["losses"], want, **TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_first_step_gradients_match_one_process(runs, layout):
    """The gradients Adam takes are the whole batch's: a uniform error of
    scale (a rank's share counted twice, say) would hardly move Adam's
    parameters, so the gradients are held themselves."""
    for trainer in TRAINERS:
        want = _one_process(trainer)[2]
        for out in runs(layout):
            _assert_params_close(out["train"][trainer]["grads"],
                                 {f: g.numpy() for f, g in want.items()})


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_agree(runs, layout):
    """Every rank ends with the same whole parameters (the replicated leaves
    too) and takes the same indexes on a batch, which equal one process's;
    a rank of a model axis holds its dim slice."""
    nm = LAYOUTS[layout][1]
    for trainer in TRAINERS:
        outs = [out["train"][trainer] for out in runs(layout)]
        t = _one_process(trainer)[0]
        _, xs = _inputs()[3][trainer]
        want = search.compute_indexes(t.params.detach(), t.config, torch.from_numpy(xs[0]), 2)
        for res in outs:
            for f in PARAM_FIELDS:
                np.testing.assert_array_equal(res["params"][f], outs[0]["params"][f], err_msg=f)
            np.testing.assert_array_equal(res["indexes"], want.numpy())
            nc, cs = t.config.num_codebooks, t.config.codebook_size
            assert res["local_centers_shape"] == (nc, cs, t.config.dim // nm)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_checkpoint_under_mesh_loads_into_one_process(runs, layout):
    """The checkpoint rank 0 writes under the mesh is whole: it loads into a
    one-process trainer equal to the mesh's, and into the mesh again equal
    to the running trainer."""
    for trainer in TRAINERS:
        res = runs(layout)[0]["train"][trainer]
        assert all(out["train"][trainer]["resume_equal"] for out in runs(layout))
        t = QuantizerTrainer.load_checkpoint(res["ckpt"], device="cpu", diagnostics=False)
        assert t.cur_iter == res["cur_iter"]
        _assert_params_close(res["params"], t.params, rtol=0, atol=0)
        _assert_params_close(res["params"], _one_process(trainer)[0].params)


def test_one_by_one_mesh_is_one_process():
    """Without a process group the mesh is 1 x 1 and its collectives are the
    identity: bulk encode and decode and the trainer equal one process bit
    for bit."""
    params, x, codes, trainers = _inputs()
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.members("data")) == ({"data": 1, "model": 1},
                                                               {"data": 0, "model": 0}, [0])
    p, cfg = params_from_numpy(params), QuantizerConfig(*CONFIG)
    assert torch.equal(encode_sharded(p, cfg, torch.from_numpy(x), mesh, 2),
                       codec.encode(p, cfg, torch.from_numpy(x), 2))
    assert torch.equal(decode_sharded(p, cfg, torch.from_numpy(codes), mesh),
                       codec.decode(p, cfg, torch.from_numpy(codes)))
    whole = gather_params(shard_params(p, mesh), mesh)
    assert all(torch.equal(getattr(whole, f), getattr(p, f)) for f in PARAM_FIELDS)
    for name in TRAINERS:
        t0, losses, grads = _one_process(name)
        t = _port_trainer(name, mesh=mesh)
        got, got_grads = _drive(t, trainers[name][1])
        np.testing.assert_array_equal(got, losses)
        assert all(torch.equal(got_grads[f], grads[f]) for f in PARAM_FIELDS)
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(t.params, f), getattr(t0.params, f)), f
