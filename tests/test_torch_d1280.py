"""d1280 / 8 B (the MVQ distillation deployment) on the CPU: the kernel's
gate, auto's ladder, the plain seqbeam and gramv3 at dim 1280 against the
benchmark's plain reference, the seeded sampler's shipped weights and the
compact quantizer file.  Imports no JAX."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import quantizer as R
from quantization_tpu_torch import Quantizer, load_quantizer, save_quantizer
from quantization_tpu_torch.core import codec
from quantization_tpu_torch.core.types import QuantizerConfig, scaled_centers
from quantization_tpu_torch.data import synthetic
from quantization_tpu_torch.experiments.head_to_head import save_int8
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import ladder
from quantization_tpu_torch.ops import quality_guard
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

D1280 = QuantizerConfig(1280, 256, 8)
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/d1280_b8.json"
BAR = 1.012  # the project's quality bar: beam-5 x 1.012


def test_kernel_gate_admits_dim_1280_and_no_wider():
    assert tseq.SEQBEAM_SUPPORTED(D1280)
    assert not tseq.SEQBEAM_SUPPORTED(QuantizerConfig(1408, 256, 8))
    assert not tseq.SEQBEAM_SUPPORTED(QuantizerConfig(1280, 16, 8))
    assert not tseq.SEQBEAM_SUPPORTED(QuantizerConfig(1344, 256, 8))  # not a multiple of 128


def test_auto_ladder_of_d1280_and_d512():
    # the Gram-table rung first, then K2's rungs behind it
    rungs = ladder.rungs(D1280)
    assert [(r.name, r.kernel, r.needs_quality) for r in rungs] == [
        ("gramv3_bf16_alt3_d1280", tg3.GRAMV3, True), ("seqbeam_int8e_d1280", tseq.SEQBEAM, True),
        ("seqbeam_hl_d1280", tseq.SEQBEAM, False)]
    assert all(r.name.endswith("_d1280") for r in rungs)
    d512 = ladder.rungs(QuantizerConfig(512, 256, 8))
    assert [(r.name, r.needs_quality) for r in d512] == [
        ("gramv3_bf16_alt3_d512", True), ("seqbeam_int8e_d512", True),
        ("seqbeam_hl_d512", False), ("seqbeam_m16_d512", False)]
    # d1280 / 16 B has K3's rung alone, named with its codebooks, for every
    # call size; no other configuration above dim 1024 has a measured rung:
    # the exact beam
    b16 = ladder.rungs(QuantizerConfig(1280, 256, 16))
    assert [(r.name, r.kernel, r.min_frames, r.needs_quality) for r in b16] == [
        ("gramv3_bf16_alt4_d1280_b16", tg3.GRAMV3, 0, True)]
    for dim, nc in ((1152, 8), (1280, 4), (1280, 2)):
        assert ladder.rungs(QuantizerConfig(dim, 256, nc)) == ()
    # both Gram-table rungs run the beam of the K2 rung beside them, with as
    # many passes (the benchmark records auto's choice from one frame)
    for config in (D1280, QuantizerConfig(512, 256, 8)):
        gram, k2 = ladder.rungs(config)[:2]
        assert gram.beam == dict(M=8, R=4, pool_mask="altparity", g_dtype="bf16")
        assert gram.knobs == {}
        assert gram.passes == k2.passes == 3
        assert {k: k2.beam[k] for k in ("M", "R", "pool_mask")} == {
            k: gram.beam[k] for k in ("M", "R", "pool_mask")}
    # the card's wide instantiations take both seqbeam rungs' beams
    for rung in rungs[1:]:
        kw = rung.beam
        assert (kw["M"], rung.passes, kw["e_dtype"]) in ((8, 3, "int8"), (8, 3, "bf16"))
        assert "requant" not in kw and "lazy_r1" not in kw


def _seeded_d1280(seed, frames=48, noise=8.0):
    """Codebooks with prediction weights near them, and frames of one
    codeword per codebook plus noise: the port's parameters, the
    reference's, and the frames."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((8, 256, 1280)) * 0.5).astype(np.float32)
    arrays = {"centers": centers,
              "to_logits_w": (centers.reshape(2048, 1280)
                              + 0.5 * rng.standard_normal((2048, 1280))).astype(np.float32),
              "to_logits_b": np.zeros(2048, np.float32),
              "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0)}
    x = (centers[np.arange(8)[None], rng.integers(0, 256, (frames, 8))].sum(1)
         + noise * rng.standard_normal((frames, 1280))).astype(np.float32)
    ref = {k: torch.from_numpy(np.asarray(arrays[k], np.float32)) for k in R.PARAMS}
    ref["scale_speed"] = D1280.scale_speed
    return params_from_numpy(arrays), ref, torch.from_numpy(x)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("rung", ["seqbeam_int8e_d1280", "seqbeam_hl_d1280",
                                  "gramv3_bf16_alt3_d1280"])
def test_plain_seqbeam_at_d1280_against_the_reference(seed, rung):
    # each rung of auto's d1280 ladder, K3's Gram-table rung among them
    params, ref, x = _seeded_d1280(seed)
    rung = next(r for r in ladder.rungs(D1280) if r.name == rung)
    kernel = rung.kernel
    idx = kernel.plain(kernel.problem(params, D1280, x, passes=rung.passes, **rung.beam))
    assert idx.shape == (x.shape[0], 8) and idx.dtype == torch.int32
    # the port's error of those indexes is the reference's
    port = ((codec.decode_indexes(scaled_centers(params, D1280.scale_speed), idx) - x) ** 2).sum()
    err = R.frame_sse(ref, x, idx).sum()
    assert float(port) == pytest.approx(float(err), rel=1e-5)
    # and within the bar of the reference's exact beam-5, which beats the init
    beam5 = R.frame_sse(ref, x, R.encode_indexes(ref, x, passes=5)).sum()
    init = R.frame_sse(ref, x, tbeam.initial_indexes(params, D1280, x)).sum()
    assert float(err) <= BAR * float(beam5)
    assert float(beam5) < float(init)


def test_shipped_d1280_sampler_is_its_seeded_draw():
    want = synthetic.seeded_mlp_weights(1280, synthetic.SEEDED_MLP_SEED)
    path = synthetic.mlp_weights_path(1280)
    assert path.name == "mlp_sampler_d1280_seed42.npz"
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.float16
            np.testing.assert_array_equal(z[k], v)
    a = 1.0 / np.sqrt(3 * 1280)
    assert set(np.unique(np.abs(want["w1"].astype(np.float32)))) == {np.float16(a)}
    x = synthetic.make_mlp_sampler(1280, device="cpu")(torch.Generator().manual_seed(3), 64)
    assert x.shape == (64, 1280) and x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    with pytest.raises(ValueError):
        synthetic.make_double_sampler(1280, device="cpu")


def test_int8_quantizer_file(tmp_path):
    q = Quantizer(256, 256, 4, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        q.centers.add_(0.3 * torch.randn(q.centers.shape, generator=g))
        q.centers_scale.fill_(0.02)
        q.logits_scale.fill_(-0.01)
    f32, small = tmp_path / "q.npz", tmp_path / "q8.npz"
    save_quantizer(f32, q)
    back = save_int8(small, q)
    assert small.stat().st_size < f32.stat().st_size / 3
    with np.load(small) as z:
        assert z["centers"].dtype == np.int8 and z["to_logits_w"].dtype == np.int8
        assert int(np.abs(z["centers"]).max()) == 127
    # the same quantizer up to half a step of each table
    c0, c1 = q.get_centers().detach(), back.get_centers().detach()
    assert float((c0 - c1).abs().max()) <= 0.5001 * float(c0.abs().max()) / 127
    w0, w1 = ((torch.exp(p.logits_scale * 10.0) * p.to_logits_w).detach()
              for p in (q.params, back.params))
    assert float((w0 - w1).abs().max()) <= 0.5001 * float(w0.abs().max()) / 127
    assert torch.equal(back.params.to_logits_b, q.params.to_logits_b)
    # the reference reads the file as the port does
    ref = R.load(small, "cpu")
    assert torch.allclose(R.scaled_centers(ref), c1, rtol=1e-6, atol=0)
    x = torch.randn(40, 256, generator=torch.Generator().manual_seed(2))
    assert torch.equal(back.encode(x, search_method="beam"),
                       R.pack(R.encode_indexes(ref, x, passes=5), 256))
    assert load_quantizer(small, device="cpu").get_id() == q.get_id()


@pytest.mark.parametrize("asset", ["quantizer", "sampler"])
def test_d1280_files_hold_the_benchmark_config_sums(asset):
    """The quantizer and sampler that the program's guard reads are the
    files that the benchmark's d1280 cell is defined by, byte for byte."""
    conf = json.loads(CONFIG.read_text())
    path = (CONFIG.parent / conf[asset]).resolve()
    ours = {"quantizer": quality_guard.TRAINED[(1280, 8)],
            "sampler": synthetic.mlp_weights_path(1280)}[asset]
    assert path == pathlib.Path(ours).resolve()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == conf["sha256"][asset]
