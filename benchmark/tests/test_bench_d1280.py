"""The d1280 / 8 B cell: it resolves by its name with its metrics, its
assets are the ones whose sums its configuration records, and the plain
reference at dim 1280 agrees with a direct float32 computation."""

import hashlib
import json

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from benchmark.lib import common
from benchmark.reference import quantizer as R

MAN = json.loads((common.ROOT / "BENCHMARK.json").read_text())
CELL = "encode_bulk.d1280_b8"


def test_cell_resolves_with_its_metrics():
    c = common.find_cell(CELL, MAN)
    assert c.chips == 1 and c.mix["driver"] == "encode_loop"
    assert (c.config["dim"], c.config["bytes_per_frame"], c.config["num_codebooks"],
            c.config["codebook_size"]) == (1280, 8, 8, 256)
    assert c.config["limits"] == {"delta_pct": 1.2} and c.config["reduced"] == {}
    assert {m["name"] for m in c.end_to_end} == {"encode_vps", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "search_roofline_pct.d1280", "encode_mfu_pct.d1280", "encode_prep_ms.d1280",
        "device_idle_pct.d1280"}
    for m in c.per_layer:
        assert m["moves"] == "encode_vps" and m["workloads"] == [CELL]
        assert callable(common.metric_reader(m["name"]).read)
    # the cells the benchmark had keep their metrics
    assert {m["name"] for m in common.find_cell("encode_bulk.d512_b8", MAN).per_layer} == {
        "search_roofline_pct.bulk", "encode_mfu_pct.bulk", "encode_prep_ms.bulk",
        "device_idle_pct.bulk"}


@pytest.mark.parametrize("key", ["quantizer", "sampler"])
def test_assets_match_the_sums_of_the_configuration(key):
    c = common.find_cell(CELL, MAN)
    path = c.asset(key)
    assert path.exists()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == c.config["sha256"][key]


def test_reference_at_d1280_is_the_direct_float32_computation():
    g = torch.Generator().manual_seed(5)
    nc, cs, dim = 8, 16, 1280
    p = {"centers": torch.randn(nc, cs, dim, generator=g) * 0.3,
         "to_logits_w": torch.randn(nc * cs, dim, generator=g) * 0.1,
         "to_logits_b": torch.randn(nc * cs, generator=g) * 0.1,
         "logits_scale": torch.tensor(0.01), "centers_scale": torch.tensor(-0.02),
         "scale_speed": 10.0}
    x = torch.randn(24, dim, generator=g)
    c64 = (np.exp(-0.02 * 10.0) * p["centers"].double())
    assert torch.allclose(R.scaled_centers(p).double(), c64, rtol=1e-6, atol=0)
    logits = (np.exp(0.01 * 10.0) * x.double()) @ p["to_logits_w"].double().t() \
        + p["to_logits_b"].double()
    assert torch.allclose(R.logits(p, x).double().reshape(24, -1), logits, rtol=0, atol=1e-4)
    idx = R.encode_indexes(p, x, passes=5)
    assert idx.shape == (24, nc) and int(idx.min()) >= 0 and int(idx.max()) < cs
    recon = c64[torch.arange(nc)[None], idx.long()].sum(1)
    assert torch.allclose(R.decode(p, idx).double(), recon, rtol=0, atol=1e-5)
    sse = ((recon - x.double()) ** 2).sum(-1)
    assert torch.allclose(R.frame_sse(p, x, idx).double(), sse, rtol=1e-5, atol=0)
    # beam-5 is no worse than the logits' argmax, frame by frame summed
    init = R.logits(p, x).argmax(-1)
    assert float(R.frame_sse(p, x, idx).sum()) <= float(R.frame_sse(p, x, init).sum())
