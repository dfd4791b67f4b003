"""d1280 / 16 B (the MVQ distillation deployment at 16 bytes a frame) on the
CPU: the Gram-table kernel's gate and auto's ladder at 16 codebooks, the
plain gramv3 at 16 codebooks against the benchmark's plain reference, the
guard's key, the configuration's file sums and a training step whose
phase-2 search is the Gram-table beam.  Imports no JAX."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference import quantizer as R
from quantization_tpu_torch.core import codec
from quantization_tpu_torch.core.types import QuantizerConfig, scaled_centers
from quantization_tpu_torch.data import synthetic
from quantization_tpu_torch.ops import beam_common as tbeam
from quantization_tpu_torch.ops import gramv3 as tg3
from quantization_tpu_torch.ops import ladder
from quantization_tpu_torch.ops import quality_guard
from quantization_tpu_torch.train.trainer import QuantizerTrainer
from quantization_tpu_torch.utils.torch_interop import params_from_numpy

B16 = QuantizerConfig(1280, 256, 16)
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/d1280_b16.json"
BAR = 1.012  # the project's quality bar: beam-5 x 1.012


def test_gramv3_gate_admits_16_codebooks():
    assert tg3.GRAMV3_SUPPORTED(B16)
    for nc in (2, 4, 8, 16):
        assert tg3.GRAMV3_SUPPORTED(QuantizerConfig(512, 256, nc))
    for nc in (1, 32):
        assert not tg3.GRAMV3_SUPPORTED(QuantizerConfig(512, 256, nc))
    assert not tg3.GRAMV3_SUPPORTED(QuantizerConfig(1280, 16, 16))
    # the card's build at 16 codebooks is auto's beam width alone
    assert tg3.BUILT_M[16] == (8,)


def test_ladder_of_d1280_b16_is_k3_alone_for_every_call():
    rungs = ladder.rungs(B16)
    assert len(rungs) == 1
    rung = rungs[0]
    assert rung.name == "gramv3_bf16_alt4_d1280_b16" == ladder.LADDERS[(1280, 16)][0].name
    assert rung.kernel is tg3.GRAMV3 and rung.min_frames == 0 and rung.needs_quality
    assert rung.beam["M"] in tg3.BUILT_M[16]
    # its name carries the codebooks; the first three configurations' do not
    assert ladder.config_tag(1280, 16) == "d1280_b16"
    assert [ladder.config_tag(*k) for k in ((512, 8), (256, 4), (1280, 8))] == [
        "d512", "d256", "d1280"]
    # no rung of d1280 / 8 B is read for it
    names_b8 = {r.name for r in ladder.LADDERS[(1280, 8)]}
    assert rung.name not in names_b8


def _seeded(seed, dim, frames=200, noise=1.0):
    """16 codebooks with prediction weights near them, and frames of one
    codeword per codebook plus noise: the port's parameters, the
    reference's, and the frames."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((16, 256, dim)) * 0.5).astype(np.float32)
    arrays = {"centers": centers,
              "to_logits_w": (centers.reshape(4096, dim)
                              + 0.5 * rng.standard_normal((4096, dim))).astype(np.float32),
              "to_logits_b": np.zeros(4096, np.float32),
              "logits_scale": np.float32(0.0), "centers_scale": np.float32(0.0)}
    x = (centers[np.arange(16)[None], rng.integers(0, 256, (frames, 16))].sum(1)
         + noise * rng.standard_normal((frames, dim))).astype(np.float32)
    config = QuantizerConfig(dim, 256, 16)
    ref = {k: torch.from_numpy(np.asarray(arrays[k], np.float32)) for k in R.PARAMS}
    ref["scale_speed"] = config.scale_speed
    return params_from_numpy(arrays), config, ref, torch.from_numpy(x)


@pytest.mark.parametrize("g_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("dim", [128, 256])
def test_plain_gramv3_at_16_codebooks_against_the_reference(dim, g_dtype):
    params, config, ref, x = _seeded(dim, dim)
    rung = ladder.LADDERS[(1280, 16)][0]
    beam = dict(rung.beam, g_dtype=g_dtype)
    idx = tg3.gramv3_plain(tg3.gramv3_problem(params, config, x, passes=rung.passes, **beam))
    assert idx.shape == (x.shape[0], 16) and idx.dtype == torch.int32
    # the port's error of those indexes is the reference's
    port = ((codec.decode_indexes(scaled_centers(params, config.scale_speed), idx) - x) ** 2).sum()
    err = R.frame_sse(ref, x, idx).sum()
    assert float(port) == pytest.approx(float(err), rel=1e-5)
    # and within the bar of the reference's exact beam-5, which beats the init
    beam5 = R.frame_sse(ref, x, R.encode_indexes(ref, x, passes=5)).sum()
    init = R.frame_sse(ref, x, tbeam.initial_indexes(params, config, x)).sum()
    assert float(err) <= BAR * float(beam5)
    assert float(beam5) < float(init)
    # the codes pack to 16 bytes a frame as the reference packs them
    codes = codec.pack_indexes(idx, 256)
    assert torch.equal(codes, R.pack(idx, 256))


def test_guard_keys_trained_quantizers_by_dim_and_codebooks():
    assert set(quality_guard.TRAINED) == {(512, 8), (256, 4), (1280, 8), (1280, 16)}
    assert quality_guard.TRAINED[(1280, 16)].name == "q1280_16_full.npz"
    assert set(quality_guard.CANDIDATES) == set(quality_guard.TRAINED)
    names = [r.name for r in quality_guard.GRAMV3_CANDIDATES[(1280, 16)]]
    assert len(names) == 12 and all(n.endswith("_d1280_b16") for n in names)
    assert ladder.LADDERS[(1280, 16)][0].name in names
    # the rows of the first three configurations keep their names
    assert "gramv3_bf16_alt3_d1280" in {r.name for r in quality_guard.GRAMV3_CANDIDATES[(1280, 8)]}


@pytest.mark.parametrize("asset", ["quantizer", "sampler"])
def test_d1280_b16_files_hold_the_benchmark_config_sums(asset):
    """The quantizer and sampler that the program's guard reads are the
    files that the benchmark's d1280 / 16 B cell is defined by, byte for
    byte."""
    conf = json.loads(CONFIG.read_text())
    path = (CONFIG.parent / conf[asset]).resolve()
    ours = {"quantizer": quality_guard.TRAINED[(1280, 16)],
            "sampler": synthetic.mlp_weights_path(1280)}[asset]
    assert path == pathlib.Path(ours).resolve()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == conf["sha256"][asset]
    if asset == "quantizer":
        with np.load(path) as z:
            assert z["centers"].shape == (16, 256, 1280) and z["centers"].dtype == np.int8


def test_training_step_with_the_gram_table_search_at_16_codebooks(monkeypatch):
    # phase 2 of a 16-byte trainer runs gramv3 (its plain version here)
    torch.manual_seed(0)
    trainer = QuantizerTrainer(128, 16, phase_one_iters=1, phase_two_iters=2, device="cpu",
                               train_search="gramv3", beam_finetune_iters=0, diagnostics=False)
    assert trainer.config.num_codebooks == 32 and trainer.config.codebook_size == 16
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(1))
    seen = []
    real = tg3.gramv3_plain
    monkeypatch.setattr(tg3, "gramv3_plain", lambda p: seen.append(p.gt.shape[0]) or real(p))
    for _ in range(3):
        trainer.step(x)
    assert trainer.config.num_codebooks == 16 and trainer.config.codebook_size == 256
    assert trainer._search_for_config(trainer.cur_iter) == "gramv3"
    assert seen and set(seen) == {16}
    q = trainer.get_quantizer()
    assert bool(torch.isfinite(q.get_centers()).all())


def test_gramv3_tables_span_records_the_table_bytes_at_16_codebooks():
    from quantization_tpu_torch.utils import spans

    params, config, _, x = _seeded(3, 128, frames=8)
    tg3.TABLES_CACHE.clear()
    spans.start()
    try:
        tg3.gramv3_problem(params, config, x, passes=1, g_dtype="int8")
        tg3.gramv3_problem(params, config, x, passes=1, g_dtype="int8")  # a hit: no build
    finally:
        records = spans.stop()
    # the int8 table, 16 x 4,096 x 256 bytes, built once
    assert [r.attrs for r in records if r.name == "gramv3.tables"] == [
        {"table_bytes": 16 * 4096 * 256}]


def test_the_rung_is_the_first_beam_whose_guard_rows_hold_the_bar():
    # bf16 altparity at 3 passes (d1280 / 8 B's beam) misses the 1% bar on
    # the card's rows; 4 passes holds it, so the rung takes 4
    from quantization_tpu_torch.ops import verify

    rung = ladder.LADDERS[(1280, 16)][0]
    assert (rung.passes, rung.beam) == (4, dict(M=8, R=4, pool_mask="altparity", g_dtype="bf16"))
    assert verify.kernel_verified(rung.name)
    assert verify.combined_margin_pct(rung.name) <= 1.0
    assert verify.combined_margin_pct("gramv3_bf16_alt3_d1280_b16") > 1.0
    for name in (r.name for r in quality_guard.GRAMV3_CANDIDATES[(1280, 16)]):
        assert verify.kernel_verified(name) and verify.quality_delta_pct(name) is not None


def test_all_rows_counter_and_the_launch_span_rows_attr():
    """Which K3 launches load all nc rows a candidate (no staged rows): a
    plain integer counts them, and the ``gramv3.launch`` span's ``rows``
    says which path ran, both documented; the path is the built kernel's
    answer (``rows_path``), asked only once the tensors pass, so a CPU
    problem is refused before any count moves or ``rows`` is set."""
    from quantization_tpu_torch.utils import spans

    assert type(tg3.ALL_ROWS_LAUNCHES) is int
    assert tg3.ALL_ROWS.symbol == "qtt_gramv3_all_rows"
    for doc in (tg3.__doc__, tg3.rows_path.__doc__, tg3._launch.__doc__):
        assert "all" in doc
    assert '"staged"' in tg3.rows_path.__doc__ and "kAllRows" in tg3.rows_path.__doc__
    assert "ALL_ROWS_LAUNCHES" in tg3._launch.__doc__ and "rows_path" in tg3._launch.__doc__
    params, config, _, x = _seeded(4, 128, frames=8)
    problem = tg3.gramv3_problem(params, config, x, passes=1)
    all_rows, nc16 = tg3.ALL_ROWS_LAUNCHES, tg3.NC_LAUNCHES[16]
    spans.start()
    try:
        with pytest.raises(ValueError, match="CUDA"):
            tg3.gramv3_cuda(problem)
    finally:
        records = spans.stop()
    assert (tg3.ALL_ROWS_LAUNCHES, tg3.NC_LAUNCHES[16]) == (all_rows, nc16)
    assert [r.attrs for r in records if r.name == "gramv3.launch"] == [
        {"g_dtype": "bf16", "nc": 16}]
