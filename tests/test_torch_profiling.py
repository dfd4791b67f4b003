"""The port's device-op profiler (``quantization_tpu_torch/utils/profiling.py``)
held to the JAX package's ``profile_device_ops``: the same row keys, order
and rounding; on the CPU its rows are CPU operators."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from quantization_tpu.utils.profiling import profile_device_ops as jax_profile
from quantization_tpu_torch.utils import profile_device_ops
from quantization_tpu_torch.utils.profiling import profile_device_ops as direct


def _inputs():
    return np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)


def test_rows_have_the_jax_keys_order_and_rounding():
    a = _inputs()
    f = jax.jit(lambda x: (x @ x).sum())
    jax.block_until_ready(f(a))  # compile outside the trace
    jrows = jax_profile(lambda: jax.block_until_ready(f(a)))
    t = torch.from_numpy(a)
    rows = profile_device_ops(lambda: (t @ t).sum(), device="cpu")
    assert profile_device_ops is direct  # the lazy export is the module's function
    assert rows, "the CPU trace holds no operator"
    keys = {"source", "ms", "count"}
    assert all(set(r) == keys for r in rows)
    assert all(set(r) == keys for r in jrows)  # JAX's rows, where its CPU trace has any
    ms = [r["ms"] for r in rows]
    assert ms == sorted(ms, reverse=True)
    assert all(m >= 0 and m == round(m, 3) for m in ms)
    assert all(isinstance(r["count"], int) and r["count"] >= 1 for r in rows)


def test_a_known_op_counts_its_calls():
    t = torch.from_numpy(_inputs())

    def run():
        for _ in range(3):
            torch.mm(t, t)
        torch.add(t, 1.0)

    rows = {r["source"]: r for r in profile_device_ops(run, device="cpu")}
    # run() is called twice, and only the second call is traced
    assert rows["aten::mm"]["count"] == 3
    assert rows["aten::add"]["count"] == 1
    assert not any(k.startswith("ProfilerStep") for k in rows)


def test_trace_dir_gets_a_chrome_trace(tmp_path):
    t = torch.from_numpy(_inputs())
    profile_device_ops(lambda: torch.mm(t, t), trace_dir=str(tmp_path / "tr"), device="cpu")
    trace = pathlib.Path(tmp_path / "tr" / "trace.json")
    assert trace.exists() and "aten::mm" in trace.read_text()


def test_without_device_it_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_device_ops(lambda: calls.append(1))
    assert calls == []  # nothing ran


@pytest.mark.parametrize("windows,attempts,want", [
    # an empty window on the card is traced again, with a warning each time
    ([{}, {}, {"kern": (1500.0, 2)}], 3, [{"source": "kern", "ms": 1.5, "count": 2}]),
    ([{"kern": (250.0, 1)}], 1, [{"source": "kern", "ms": 0.25, "count": 1}]),
    # after the last attempt the empty table is returned
    ([{}, {}, {}], 3, []),
])
def test_an_empty_window_on_the_card_is_traced_again(monkeypatch, caplog, windows, attempts,
                                                     want):
    import collections
    import logging

    from quantization_tpu_torch.utils import profiling

    assert profiling.TRACE_ATTEMPTS == 3
    seen = []

    def one_window(run, device, trace_dir):  # in place of torch.profiler on a card
        w = windows[len(seen)]
        seen.append(device.type)
        return (collections.Counter({k: us for k, (us, _) in w.items()}),
                collections.Counter({k: n for k, (_, n) in w.items()}))

    monkeypatch.setattr(profiling, "_trace", one_window)
    with caplog.at_level(logging.WARNING, logger=profiling.__name__):
        rows = profile_device_ops(lambda: None, device="cuda")
    assert rows == want
    assert seen == ["cuda"] * attempts
    assert len(caplog.records) == attempts - 1


def test_an_empty_cpu_window_is_not_traced_again(monkeypatch):
    import collections

    from quantization_tpu_torch.utils import profiling

    seen = []
    monkeypatch.setattr(profiling, "_trace", lambda run, device, trace_dir: (
        seen.append(device.type) or (collections.Counter(), collections.Counter())))
    assert profile_device_ops(lambda: None, device="cpu") == []
    assert seen == ["cpu"]
