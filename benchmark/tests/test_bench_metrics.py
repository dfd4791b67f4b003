"""The per-layer readers' arithmetic, on synthetic trace segments: the
kernels' counts against the bounds of PERF.md's kernel table, the model
FLOPs of the mfu metrics (the same whichever search the codec reports),
and the union of device intervals behind the idle share."""

import _paths  # noqa: F401
import pytest

from benchmark.lib import common, reading
from benchmark.lib.trace import Segment, breakdown, busy_s, idle_gaps, union_length

K2_INT8 = "void seqbeam_kernel<2, 8, false, 0, false, false, false>(Args)"
K2_BF16 = "void seqbeam_kernel<1, 8, false, 0, false, false, false>(Args)"
B4 = "void seqbeam_kernel<0, 16, true, 0, false, false, false>(Args)"


def _reading(cell, segments):
    return reading.make(segments, common.find_cell(cell))


def _bound_ms(cell, op, passes, frames=32768):
    r = _reading(cell, [Segment(0, 1, [], [], {})])
    conf = r.cell.config
    count = r.count_for(op)
    work = count.work(op, {"frames": frames, "dim": conf["dim"],
                           "num_codebooks": conf["num_codebooks"], "passes": passes})
    return 1e3 * r.least_seconds(work)


@pytest.mark.parametrize("cell,op,passes,table_ms", [
    ("encode_bulk.d512_b8", K2_INT8, 3, 0.7553),
    ("encode_bulk.d512_b8", K2_BF16, 3, 1.4852),
    ("encode_bulk.d256_b4", K2_BF16, 2, 0.2171),
    ("encode_bulk.d512_b8", B4, 3, 2.9444),
    ("encode_bulk.d256_b4", B4, 3, 0.6384),
    ("encode_bulk.d512_b8", "void gramv3_kernel<false, 8, 8, false>(Args)", 5, 0.5709),
    ("encode_bulk.d512_b8", "void gramv3_kernel<true, 8, 8, false>(Args)", 5, 0.3255),
    ("encode_bulk.d256_b4", "void gramv3_kernel<false, 4, 8, false>(Args)", 5, 0.1252),
    ("encode_bulk.d256_b4", "void gramv3_kernel<true, 4, 8, false>(Args)", 5, 0.0726),
])
def test_counts_give_the_kernel_tables_bounds(cell, op, passes, table_ms):
    assert _bound_ms(cell, op, passes) == pytest.approx(table_ms, abs=6e-5)


def _bulk_segment(op, choice, kernel_s=0.010, calls=4):
    ops = []
    t = 0.0
    for _ in range(calls):
        ops.append(("logits_gemm", t, t + 0.002))
        ops.append((op, t + 0.002, t + 0.002 + kernel_s))
        t += 0.0125
    return Segment(0.0, t, ops, [("encode_call", 0.0, t)],
                   {"calls": calls, "frames": calls * 32768, "sizes": [32768] * calls,
                    "choice": choice})


def test_roofline_share_and_prep():
    seg = _bulk_segment(K2_INT8, ("seqbeam_int8e_d512", 3, {}))
    r = _reading("encode_bulk.d512_b8", [seg])
    roof = common.metric_reader("search_roofline_pct.bulk").read(r)
    assert roof == pytest.approx(100 * 0.7553e-3 / 0.010, rel=1e-3)
    assert common.metric_reader("encode_prep_ms.bulk").read(r) == pytest.approx(2.0)
    assert common.metric_reader("encode_ops_per_call.stream").read(r) == 2
    # a search kernel the benchmark has no count for reads nothing
    odd = _bulk_segment("void seqbeam_kernel<7, 8, false>(Args)", ("x", 3, {}))
    assert common.metric_reader("search_roofline_pct.bulk").read(
        _reading("encode_bulk.d512_b8", [odd])) is None


@pytest.mark.parametrize("choice,op", [
    (("seqbeam_int8e_d512", 3, {}), K2_INT8),
    (("gramv3", 5, {}), "void gramv3_kernel<false, 8, 8, false>(Args)"),
    (None, "aten::topk"),
])
def test_encode_mfu_depends_on_the_shapes_alone(choice, op):
    seg = _bulk_segment(op, choice)
    r = _reading("encode_bulk.d512_b8", [seg])
    mfu = common.metric_reader("encode_mfu_pct.bulk").read(r)
    flops = 2 * 512 * 8 * 256 * seg.info["frames"]
    assert mfu == pytest.approx(100 * flops / seg.wall_s / 989e12)


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (9.0, 12.0)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert idle_gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    seg = Segment(0.0, 10.0, [("a", s, e) for s, e in iv],
                  [("encode_call", 0.0, 5.0), ("synchronize", 3.9, 5.0)], {})
    assert busy_s([seg]) == pytest.approx(4.0)
    b = breakdown([seg])
    assert dict(b["idle_gaps"]) == {"between spans": pytest.approx(4.0),
                                    "encode_call": pytest.approx(1.0),
                                    "synchronize": pytest.approx(1.0)}
    assert b["device_ops"][0][0] == "a"
