"""On the card: one short run of a cell prints a well-formed, correct
result line, and the control at the cell's own size fails the check that
the program passes.  Run there with
``python -m pytest -q -m gpu benchmark/tests/test_bench_gpu.py``; each
skips without a card."""

import json
import subprocess
import sys

import _paths
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_prints_a_correct_result():
    _need_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "encode_bulk.d256_b4", "--seed", str(2**31 + 7), "--seconds", "3",
                          "--trace", "0"], cwd=_paths.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "encode_vps.d256"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    _need_card()
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                          "encode_bulk.d256_b4", "--seeds", str(2**31 + 8), "--seconds", "2",
                          "--modes", "program,control"], cwd=_paths.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(s) for s in out.stdout.splitlines() if s.startswith("{")]
    delta = {ln["mode"]: ln["checks"]["delta_pct"] for ln in lines if "mode" in ln}
    assert delta["program"] <= 1.2 < delta["control"]
