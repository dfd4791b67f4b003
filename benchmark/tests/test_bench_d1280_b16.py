"""The d1280 / 16 B cell: it resolves by its name with its metrics, its
assets are the ones whose sums its configuration records, and the plain
reference at 16 codebooks agrees with a direct float32 computation."""

import hashlib
import json

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from benchmark.counts import gramv3 as count
from benchmark.lib import common
from benchmark.reference import quantizer as R

MAN = json.loads((common.ROOT / "BENCHMARK.json").read_text())
CELL = "encode_bulk.d1280_b16"


def test_cell_resolves_with_its_metrics():
    c = common.find_cell(CELL, MAN)
    assert c.chips == 1 and c.mix["driver"] == "encode_loop"
    assert (c.config["dim"], c.config["bytes_per_frame"], c.config["num_codebooks"],
            c.config["codebook_size"]) == (1280, 16, 16, 256)
    assert (c.config["phase_one_num_codebooks"], c.config["phase_one_codebook_size"]) == (32, 16)
    assert c.config["limits"] == {"delta_pct": 1.2} and c.config["reduced"] == {}
    assert "num_codebooks" in c.config["assumed"]
    assert {m["name"] for m in c.end_to_end} == {"encode_vps", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "search_roofline_pct.d1280_b16", "encode_mfu_pct.d1280_b16", "encode_prep_ms.d1280_b16",
        "device_idle_pct.d1280_b16"}
    for m in c.per_layer:
        assert m["moves"] == "encode_vps" and m["workloads"] == [CELL]
        assert callable(common.metric_reader(m["name"]).read)
    # the d1280 / 8 B cell keeps its metrics and its configuration
    d8 = common.find_cell("encode_bulk.d1280_b8", MAN)
    assert {m["name"] for m in d8.per_layer} == {
        "search_roofline_pct.d1280", "encode_mfu_pct.d1280", "encode_prep_ms.d1280",
        "device_idle_pct.d1280"}
    assert d8.config["num_codebooks"] == 8


@pytest.mark.parametrize("key", ["quantizer", "sampler"])
def test_assets_match_the_sums_of_the_configuration(key):
    c = common.find_cell(CELL, MAN)
    path = c.asset(key)
    assert path.exists()
    assert hashlib.sha256(path.read_bytes()).hexdigest() == c.config["sha256"][key]


def test_search_count_reads_the_16_codebook_instantiation():
    # the frozen count takes the kernel's name as a trace shows it, any nc
    name = "void (anonymous namespace)::gramv3_kernel<false, 16, 8, false>((anonymous namespace)::Args)"
    call = {"frames": 8192, "dim": 1280, "num_codebooks": 16, "passes": 3}
    work = count.work(name, call)
    rows = (1 + 15 * 8) * 16
    assert work["ops"] == {"f32": 8192 * 3 * rows * 256}
    assert work["bytes"] == (8192 * 4096 * 4 + 8192 * 16 * 4 + 8192 * 4 + 4096 * 4096 * 2
                             + 8192 * 16 * 4)
    int8 = count.work(name.replace("<false", "<true"), call)
    assert int8["ops"]["f32"] < work["ops"]["f32"]


def test_reference_at_16_codebooks_is_the_direct_float32_computation():
    g = torch.Generator().manual_seed(6)
    nc, cs, dim = 16, 16, 1280
    p = {"centers": torch.randn(nc, cs, dim, generator=g) * 0.3,
         "to_logits_w": torch.randn(nc * cs, dim, generator=g) * 0.1,
         "to_logits_b": torch.randn(nc * cs, generator=g) * 0.1,
         "logits_scale": torch.tensor(0.01), "centers_scale": torch.tensor(-0.02),
         "scale_speed": 10.0}
    x = torch.randn(24, dim, generator=g)
    c64 = (np.exp(-0.02 * 10.0) * p["centers"].double())
    idx = R.encode_indexes(p, x, passes=5)
    assert idx.shape == (24, nc) and int(idx.min()) >= 0 and int(idx.max()) < cs
    recon = c64[torch.arange(nc)[None], idx.long()].sum(1)
    assert torch.allclose(R.decode(p, idx).double(), recon, rtol=0, atol=1e-5)
    sse = ((recon - x.double()) ** 2).sum(-1)
    assert torch.allclose(R.frame_sse(p, x, idx).double(), sse, rtol=1e-5, atol=0)
    # beam-5 is no worse than the logits' argmax, nor than one pass
    init = R.logits(p, x).argmax(-1)
    one = R.encode_indexes(p, x, passes=1)
    assert float(R.frame_sse(p, x, idx).sum()) <= float(R.frame_sse(p, x, one).sum())
    assert float(R.frame_sse(p, x, one).sum()) <= float(R.frame_sse(p, x, init).sum())
    # 16 indexes of 256 pack to 16 bytes, one a byte, and back
    big = torch.randint(0, 256, (5, 16), generator=g)
    codes = R.pack(big, 256)
    assert codes.shape == (5, 16) and codes.dtype == torch.uint8
    assert torch.equal(R.unpack(codes, 256, 16), big)
