"""Weights carried across: the port's loaders, savers and parameter interop
held against the JAX package, the shipped sampler weights against the JAX
construction, and the port's independence from JAX."""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu.core.types import QuantizerParams as JParams
from quantization_tpu.data import synthetic as jsynth
from quantization_tpu.models.quantizer import Quantizer as JQuantizer
from quantization_tpu.utils import serialization as jser
from quantization_tpu.utils import torch_interop as jinterop
from quantization_tpu_torch.data import synthetic as tsynth
from quantization_tpu_torch.utils import torch_interop as tinterop

ROOT = pathlib.Path(__file__).resolve().parents[1]
Q512 = ROOT / "experiments" / "q512_8_full.npz"
FIELDS = tinterop.PARAM_FIELDS
REFERENCE_KEYS = {"to_logits.weight", "to_logits.bias", "centers", "logits_scale",
                  "centers_scale", "id_buf"}


def _arrays(q):
    return {k: np.asarray(getattr(q.params, k)) for k in FIELDS}


def test_trained_npz_round_trips(tmp_path):
    jq = jser.load_quantizer(Q512)
    tq = qtt.load_quantizer(Q512, device="cpu")
    assert (tq.dim, tq.codebook_size, tq.num_codebooks) == (512, 256, 8)
    assert tq.get_id() == jq.get_id()
    for k, v in _arrays(jq).items():
        np.testing.assert_array_equal(tinterop.params_to_numpy(tq.params)[k], v)
    out = tmp_path / "q.npz"
    qtt.save_quantizer(out, tq)
    back = jser.load_quantizer(out)  # the JAX package reads what the port wrote
    assert back.get_id() == jq.get_id() and back.config == jq.config
    for k, v in _arrays(jq).items():
        np.testing.assert_array_equal(_arrays(back)[k], v)


def test_jax_state_dict_loads_strict():
    jq = jser.load_quantizer(Q512)
    sd = jinterop.to_torch_state_dict(jq)
    tq = qtt.Quantizer(512, 256, 8, device="cpu")
    assert set(tq.state_dict()) == REFERENCE_KEYS
    tq.load_state_dict(sd, strict=True)
    for k, v in tq.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert tq.get_id() == jq.get_id()


@pytest.mark.parametrize("dim,cs,nc", [(32, 16, 4), (64, 256, 2)])
def test_to_torch_state_dict_equals_jax(dim, cs, nc, tmp_path):
    # one quantizer's parameters carried across by params_from_numpy: the
    # same keys, dtypes, shapes and values as the JAX package's dict
    rng = np.random.default_rng(dim + cs)
    arrays = {"centers": rng.standard_normal((nc, cs, dim)).astype(np.float32),
              "to_logits_w": rng.standard_normal((nc * cs, dim)).astype(np.float32),
              "to_logits_b": rng.standard_normal(nc * cs).astype(np.float32),
              "logits_scale": np.float32(0.125), "centers_scale": np.float32(-0.25)}
    jq = JQuantizer(dim, cs, nc, params=JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                    id_str="0123abcd")
    tq = qtt.Quantizer(dim, cs, nc, params=tinterop.params_from_numpy(arrays),
                       id_str="0123abcd", device="cpu")
    want, got = jinterop.to_torch_state_dict(jq), tinterop.to_torch_state_dict(tq)
    assert set(got) == set(want) == REFERENCE_KEYS
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and got[k].device.type == "cpu"
        assert torch.equal(got[k], v), k
    # save_torch_quantizer writes that dict
    tinterop.save_torch_quantizer(tmp_path / "q.pt", tq)
    saved = torch.load(tmp_path / "q.pt", weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in want.items())


def test_pt_round_trip(tmp_path):
    tq = qtt.load_quantizer(Q512, device="cpu")
    path = tmp_path / "quantizer.pt"
    qtt.save_quantizer(path, tq)
    back = qtt.load_quantizer(path, device="cpu")
    assert back.get_id() == tq.get_id()
    for k, v in tq.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    jq = jser.load_quantizer(path)  # and the JAX package reads the port's .pt
    np.testing.assert_array_equal(np.asarray(jq.params.centers), tq.centers.detach().numpy())


def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    arrays = {
        "centers": rng.standard_normal((4, 16, 32)).astype(np.float32),
        "to_logits_w": rng.standard_normal((64, 32)).astype(np.float32),
        "to_logits_b": rng.standard_normal(64).astype(np.float32),
        "logits_scale": np.float32(0.25),
        "centers_scale": np.array([-0.5], np.float32),
    }
    p = tinterop.params_from_numpy(arrays)
    assert p.logits_scale.shape == () and p.centers_scale.shape == ()
    back = tinterop.params_to_numpy(p)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], np.asarray(v).reshape(back[k].shape))
    jp = JParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    np.testing.assert_array_equal(qtt.core.scaled_centers(p, 10.0).numpy(),
                                  np.asarray(jnp.exp(jp.centers_scale * 10.0) * jp.centers))
    with pytest.raises(ValueError):
        tinterop.params_from_numpy({**arrays, "to_logits_b": arrays["to_logits_b"][:3]})


@pytest.mark.parametrize("dim", [256, 512])
def test_shipped_sampler_weights_equal_jax_construction(dim):
    # make_mlp_sampler(dim, PRNGKey(42)): three linear layers from split keys
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    with np.load(tsynth.mlp_weights_path(dim)) as z:
        for i, k in enumerate((k1, k2, k3), start=1):
            w, b = jsynth._linear_params(k, dim, dim)
            np.testing.assert_array_equal(z[f"w{i}"], np.asarray(w))
            np.testing.assert_array_equal(z[f"b{i}"], np.asarray(b))


def test_sampler_matches_jax_on_same_noise(monkeypatch):
    # the MLP in torch vs JAX on the same input noise: f32 matmuls in
    # another summation order, so a relative tolerance
    dim = 256
    noise = np.random.default_rng(1).standard_normal((16, dim)).astype(np.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    (w1, b1), (w2, b2), (w3, b3) = (jsynth._linear_params(k, dim, dim) for k in (k1, k2, k3))
    h = jax.nn.relu(noise @ w1.T + b1)
    h = jax.nn.relu(h @ w2.T + b2)
    mu = h.mean(-1, keepdims=True)
    h = (h - mu) * jax.lax.rsqrt(((h - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    want = np.asarray(h @ w3.T + b3 + 0.05 * noise)

    sampler = tsynth.make_mlp_sampler(dim, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(noise.copy()))
        got = sampler(torch.Generator().manual_seed(0), 16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # a seed fixes the frames
    a = sampler(torch.Generator().manual_seed(3), 8)
    assert torch.equal(a, sampler(torch.Generator().manual_seed(3), 8))
    assert tsynth.shannon_distortion(dim, 4) == jsynth.shannon_distortion(dim, 4)
    g = tsynth.gaussian_sampler(dim, device="cpu")(torch.Generator().manual_seed(0), 4096)
    assert abs(float(g.std()) - 1.0) < 0.01 and math.isfinite(float(g.mean()))


def test_entry_points_need_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qtt.Quantizer(64, 16, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qtt.load_quantizer(Q512)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.make_mlp_sampler(256)
    q = qtt.Quantizer(64, 16, 4, device="cpu", generator=torch.Generator().manual_seed(0))
    assert q.device.type == "cpu" and len(q.get_id()) == 8
    assert q.show_init_invocation().endswith("(dim=64, codebook_size=16, num_codebooks=4)")
    assert isinstance(q.to_logits, torch.nn.Linear)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "quantization_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "quantization_tpu", "triton"), (f, name)


@pytest.mark.parametrize("dim", [256, 512])
def test_shipped_double_sampler_weights_equal_jax_construction(dim):
    # make_double_sampler(dim, PRNGKey(42)): two dim/2 MLP samplers, one from
    # each key of split(PRNGKey(42)), three linear layers each
    paths = tsynth.double_weights_paths(dim)
    for path, key in zip(paths, jax.random.split(jax.random.PRNGKey(42))):
        with np.load(path) as z:
            for i, k in enumerate(jax.random.split(key, 3), start=1):
                w, b = jsynth._linear_params(k, dim // 2, dim // 2)
                np.testing.assert_array_equal(z[f"w{i}"], np.asarray(w))
                np.testing.assert_array_equal(z[f"b{i}"], np.asarray(b))
    assert len(paths) == 2


def test_double_sampler_matches_jax_halves_on_same_noise(monkeypatch):
    # the JAX sampler's two halves, each its MLP on its own noise, then
    # concatenated (quantization_tpu/data/synthetic.py:55-68)
    dim, half = 256, 128
    rng = np.random.default_rng(2)
    noise = [rng.standard_normal((8, half)).astype(np.float32) for _ in range(2)]
    want = []
    for key, z in zip(jax.random.split(jax.random.PRNGKey(42)), noise):
        (w1, b1), (w2, b2), (w3, b3) = (jsynth._linear_params(k, half, half)
                                        for k in jax.random.split(key, 3))
        h = jax.nn.relu(z @ w1.T + b1)
        h = jax.nn.relu(h @ w2.T + b2)
        mu = h.mean(-1, keepdims=True)
        h = (h - mu) * jax.lax.rsqrt(((h - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
        want.append(np.asarray(h @ w3.T + b3 + 0.05 * z))
    sampler = tsynth.make_double_sampler(dim, device="cpu")
    draws = iter(noise)
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", lambda *a, **k: torch.from_numpy(next(draws).copy()))
        got = sampler(torch.Generator().manual_seed(0), 8).numpy()
    np.testing.assert_allclose(got, np.concatenate(want, axis=-1), rtol=1e-4, atol=1e-5)
    a = sampler(torch.Generator().manual_seed(3), 4)
    assert a.shape == (4, dim) and torch.equal(a, sampler(torch.Generator().manual_seed(3), 4))


def test_double_sampler_dims_and_device(monkeypatch):
    with pytest.raises(ValueError, match="dim=128"):
        tsynth.make_double_sampler(128, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.make_double_sampler(512)
