"""The port's quality-parity run (``quantization_tpu_torch/experiments/
head_to_head.py``) on the CPU at a small size: its eval against the JAX
head-to-head formula with the JAX package's ``Quantizer`` on the same
parameters and frames, its record lookup and bars against the committed
``experiments/head_to_head_*.json``, the two-rank run against one process,
and the entry point's refusal to run without a card or ``--device``."""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from quantization_tpu.core.types import QuantizerParams as JParams
from quantization_tpu.models.quantizer import Quantizer as JQuantizer
from quantization_tpu_torch.experiments import head_to_head as h2h
from quantization_tpu_torch.utils.torch_interop import params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_run():
    return h2h.run(256, 4, 3, 3, 64, device="cpu")


def test_rel_err_equals_the_jax_formula(small_run):
    # experiments/head_to_head.py:96-99 with the JAX Quantizer, on the
    # parameters the port trained and the port's eval frames
    result, q = small_run
    assert (result["steps"], result["ranks"], result["device"]) == (7, 1, "cpu")
    assert (q.codebook_size, q.num_codebooks) == (256, 4)
    arrays = params_to_numpy(q.params)
    jq = JQuantizer(256, 256, 4, params=JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    x = h2h.eval_frames(256, "cpu").numpy()
    recon = np.asarray(jq.decode(jq.encode(x, search_method="beam")))
    mean = np.asarray(jq.get_data_mean())
    want = float(((recon - x) ** 2).sum() / ((x - mean) ** 2).sum())
    np.testing.assert_allclose(result["rel_err"], want, rtol=1e-5)
    assert result["rel_err_beam"] == result["rel_err"]
    # off the card auto is the beam and the kernel decode its plain bf16 sum
    assert abs(result["auto_delta_pct"]) < 0.1
    assert all(np.isfinite(result[k]) for k in ("wall_s", "train_s", "data_s", "steps_per_s"))


def test_records_are_the_committed_runs():
    assert h2h.records(512, 8, 10000, 10000, 600) == {
        "jax": [0.5655498504638672, 0.5656559467315674], "ref": 0.5655941963195801}
    seqbeam = h2h.records(512, 8, 10000, 10000, 600, "seqbeam", 1000)
    assert len(seqbeam["jax"]) == 4 and seqbeam["jax"][0] == 0.5682108402252197
    # the JAX "auto" record trained with the seqbeam kernel (its
    # ours_search says so), which the port's auto does not
    assert h2h.records(512, 8, 10000, 10000, 600, "auto")["jax"] == []
    # another batch is another config
    assert h2h.records(512, 8, 1000, 1000, 600) == {"jax": [], "ref": None}
    for args in ((512, 8, 10000, 10000, "seqbeam", 1000, 1), (512, 8, 10000, 10000, "beam", 0, 2),
                 (256, 4, 1000, 1000)):
        assert (ROOT / "experiments" / f"{h2h.stem(*args)}.json").exists(), args


def _fake(dim, bpf, p1, p2, batch, rel_err, auto_delta_pct):
    return {"dim": dim, "bytes_per_frame": bpf, "p1": p1, "p2": p2, "batch": batch,
            "search": "beam", "ft": 0, "seed": 0, "ranks": 1, "rel_err": rel_err,
            "auto_delta_pct": auto_delta_pct}


@pytest.mark.parametrize("rel_err,ref_ok,jax_ok", [(0.5849, True, True), (0.5780, True, False),
                                                   (0.5930, False, False)])
def test_bars_of_a_recorded_config(rel_err, ref_ok, jax_ok, monkeypatch, tmp_path, capsys):
    # d512 / 8 B, 1000 + 1000 at batch 300: JAX 0.58486, reference 0.58556;
    # 0.5780 is more than 1% below JAX's, 0.5930 more than 1% above both
    monkeypatch.setattr(h2h, "H2H_DIR", tmp_path)
    monkeypatch.setattr(h2h, "run", lambda *a: (_fake(512, 8, 1000, 1000, 300, rel_err, 0.9),
                                                None))
    rc = h2h.main(["512", "8", "1000", "1000", "300", "--device", "cpu"])
    assert rc == (0 if ref_ok and jax_ok else 1)
    out = json.loads((tmp_path / "head_to_head_d512_b8_1000+1000.json").read_text())
    assert out["ok"] is (rc == 0) and out["jax_rel_err"] == [0.58486008644104]
    assert out["ratio_ref"] == pytest.approx(rel_err / 0.5855633616447449)
    assert out["bars"]["i_ref"]["ok"] is ref_ok and out["bars"]["ii_jax"]["ok"] is jax_ok
    assert "no record" not in capsys.readouterr().out


@pytest.mark.parametrize("delta,rc", [(0.9, 0), (1.3, 1)])
def test_an_unrecorded_config_holds_the_auto_bar_alone(delta, rc, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(h2h, "H2H_DIR", tmp_path)
    monkeypatch.setattr(h2h, "run", lambda *a: (_fake(256, 4, 3, 3, 64, 0.9, delta), None))
    assert h2h.main(["256", "4", "3", "3", "64", "--device", "cpu"]) == rc
    printed = capsys.readouterr().out
    assert "[i_ref] no record" in printed and "[ii_jax] no record" in printed
    out = json.loads((tmp_path / "head_to_head_d256_b4_3+3.json").read_text())
    assert out["jax_rel_err"] is None and out["ref_rel_err"] is None and out["ok"] is (rc == 0)


def test_two_ranks_train_as_one_process(small_run, monkeypatch, tmp_path):
    # a 2 x 1 gloo mesh, each rank half of every batch: the final error
    # within bar (ii) of the one-process run's JSON
    result, _ = small_run
    (tmp_path / "head_to_head_d256_b4_3+3.json").write_text(json.dumps(result))
    two, q = h2h.run(256, 4, 3, 3, 64, device="cpu", ranks=2)
    assert two["ranks"] == 2 and two["steps"] == 7 and q.num_codebooks == 4
    held = h2h.hold(two, own=tmp_path)
    assert held["bars"]["ii_one_process"]["ok"], held
    assert held["one_process_rel_err"] == result["rel_err"]


def test_entry_point_needs_a_card_or_device():
    # with no card visible the entry point refuses to run without --device
    proc = subprocess.run([sys.executable, "-m", "quantization_tpu_torch.experiments.head_to_head",
                           "256", "4", "3", "3", "64"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert proc.stdout == ""
