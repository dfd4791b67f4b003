"""The check fails what it must: the harness, its look for a card
skipped, drives a run on the CPU at a small size with the timed path
broken underneath (each fault of ``lib/faults.py``) and with the control
in the program's place, and ``correct`` comes out false; the same run
unbroken comes out true."""

import time

import _paths  # noqa: F401
import pytest
import torch

from benchmark import run
from benchmark.lib import common
from benchmark.lib.faults import FAULTS, encode_fault

SEED = 2**31 + 99


def _small(cell_name):
    cell = common.find_cell(cell_name)
    cell.mix.update(sizes=[96, 160], pool_frames=1024, warm_calls=1, sample_calls=3)
    return cell


def _run(cell):
    torch.manual_seed(0)
    return run.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell_name", ["encode_bulk.d256_b4", "encode_stream.d512_b8"])
def test_sound_run_is_correct(cell_name):
    cell = _small(cell_name)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["detail"]["rel_err"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell_name", ["encode_bulk.d256_b4", "encode_stream.d512_b8"])
def test_fault_is_caught(cell_name, fault):
    cell = _small(cell_name)
    with encode_fault(fault):
        out = _run(cell)
    assert not out["correct"], out["checks"]


def test_control_fails_the_encode_check():
    """The plain reference cut to one beam pass, in the program's place."""
    from benchmark import control
    from benchmark.reference import quantizer as R

    cell = _small("encode_bulk.d256_b4")
    cell.mix.update(sizes=[512], pool_frames=2048)
    drv = cell.driver
    st = drv.setup(cell, SEED, "cpu", run_tracer())
    st.encode = control.reference_encoder(R.load(cell.asset("quantizer"), "cpu"), cell.config,
                                          1, None)
    drv.window(st, 0.2)
    out = drv.check(st, cell.config["limits"])
    delta = dict((n, v) for n, v, _ in out["checks"])["delta_pct"]
    assert delta > cell.config["limits"]["delta_pct"]


def run_tracer():
    from benchmark.lib.trace import Tracer

    return Tracer(False)
