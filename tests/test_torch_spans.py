"""The port's span recorder (``quantization_tpu_torch/utils/spans.py``) and
the spans of the encode path, on the CPU.

On a CPU tensor the encode path reaches neither the kernel's launch
(``seqbeam.launch``: the plain version runs) nor, for an explicit search
method, the auto choice (``codec.choose``); both are recorded where they
are reached: ``_launch`` on a CPU problem records its span and raises, and
``"auto"`` records its choice (the beam, off the card).  ``seqbeam.tables``
is recorded where the tables are built: on a miss of their cache
(``ops/seqbeam.py::TABLES_CACHE``).  The card's full path is held by
``tests/test_torch_gpu.py``."""

import threading

import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu_torch.ops import seqbeam as tseq
from quantization_tpu_torch.utils import spans

DIM, NC, B = 128, 2, 12


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


@pytest.fixture(scope="module")
def quantizer():
    return qtt.Quantizer(DIM, 256, NC, generator=torch.Generator().manual_seed(0), device="cpu")


def _frames(n=B, seed=1):
    return torch.randn(n, DIM, generator=torch.Generator().manual_seed(seed))


def _encode_spans(q, **kw):
    spans.start()
    q.encode(_frames(), refine_indexes_iters=3, **kw)
    return sorted(spans.stop(), key=lambda r: (r.start_ns, r.span_id))


def _held_in_one_call(records):
    """Each record's parent is recorded and holds it in time; all share the
    outermost span's id as their call id."""
    by_id = {r.span_id: r for r in records}
    (root,) = [r for r in records if r.parent_id is None]
    for r in records:
        assert r.call_id == root.span_id
        assert r.start_ns <= r.end_ns
        if r is not root:
            parent = by_id[r.parent_id]
            assert parent.start_ns <= r.start_ns and r.end_ns <= parent.end_ns
    return by_id


def test_off_span_is_the_shared_noop_and_keeps_nothing():
    a, b = spans.span("a"), spans.span("b", frames=3)
    assert a is b
    with a as inside:
        assert inside is a
    assert spans.stop() == []


def test_set_adds_attributes_inside_the_block():
    with spans.span("off") as sp:
        sp.set(layout="full")  # off: the shared no-op takes and keeps nothing
    spans.start()
    with spans.span("a", frames=3) as sp:
        sp.set(layout="full", chunks=10)
    with spans.span("b") as sp:
        sp.set(smem_bytes=7)
    records = spans.stop()
    assert [(r.name, r.attrs) for r in records] == [
        ("a", {"frames": 3, "layout": "full", "chunks": 10}), ("b", {"smem_bytes": 7})]


def test_seqbeam_encode_records_each_stage_nested():
    # a quantizer of its own: its first encode builds the tables
    q = qtt.Quantizer(DIM, 256, NC, generator=torch.Generator().manual_seed(0), device="cpu")
    records = _encode_spans(q, search_method="seqbeam")
    assert [r.name for r in records] == ["quantizer.encode", "codec.search", "seqbeam.init",
                                         "seqbeam.tables", "codec.pack"]
    by_id = _held_in_one_call(records)
    parents = {r.name: by_id[r.parent_id].name for r in records if r.parent_id is not None}
    assert parents == {"codec.search": "quantizer.encode", "seqbeam.init": "codec.search",
                       "seqbeam.tables": "codec.search", "codec.pack": "quantizer.encode"}
    assert records[0].attrs == {"frames": B}
    assert all(r.attrs == {} for r in records[1:])
    assert len({r.thread_id for r in records}) == 1


def test_auto_encode_off_the_card_records_its_choice_of_the_beam(quantizer):
    records = _encode_spans(quantizer)
    assert [r.name for r in records] == ["quantizer.encode", "codec.choose", "codec.search",
                                         "codec.pack"]
    by_id = _held_in_one_call(records)
    assert {by_id[r.parent_id].name for r in records[1:]} == {"quantizer.encode"}


@pytest.mark.parametrize("as_bytes,names", [
    (True, ["quantizer.encode", "codec.search", "codec.pack"]),
    (False, ["quantizer.encode", "codec.search"]),
])
def test_beam_encode_records_search_and_pack_only(quantizer, as_bytes, names):
    records = _encode_spans(quantizer, search_method="beam", as_bytes=as_bytes)
    assert [r.name for r in records] == names
    _held_in_one_call(records)


def test_launch_span_covers_the_checks(quantizer):
    problem = tseq.seqbeam_problem(quantizer.params, quantizer.config, _frames(), 8, 4, 2,
                                   e_dtype="bf16")
    spans.start()
    with pytest.raises(ValueError, match="CUDA"):
        tseq._launch(problem, tseq.SEQBEAM_KERNEL)
    (rec,) = spans.stop()
    assert rec.name == "seqbeam.launch" and rec.parent_id is None


def test_each_call_has_its_own_call_id(quantizer):
    tseq.TABLES_CACHE.clear()
    spans.start()
    for seed in range(3):
        quantizer.encode(_frames(seed=seed), search_method="seqbeam", refine_indexes_iters=3)
    records = spans.stop()
    calls = [r for r in records if r.name == "quantizer.encode"]
    assert len(calls) == 3
    assert sorted({r.call_id for r in records}) == sorted(r.span_id for r in calls)
    # the first call builds the tables, the later ones find them cached
    assert sum(r.name == "seqbeam.tables" for r in records) == 1


def test_tables_span_counts_the_builds_only():
    q = qtt.Quantizer(DIM, 256, NC, generator=torch.Generator().manual_seed(2), device="cpu")
    spans.start()
    for seed in range(3):
        q.encode(_frames(seed=seed), search_method="seqbeam", refine_indexes_iters=3)
    first = spans.stop()
    with torch.no_grad():
        q.centers.add_(0.01)
    spans.start()
    q.encode(_frames(), search_method="seqbeam", refine_indexes_iters=3)
    second = spans.stop()
    assert [r.name for r in first].count("quantizer.encode") == 3
    assert [r.name for r in first].count("seqbeam.tables") == 1
    assert [r.name for r in second].count("seqbeam.tables") == 1


def test_threads_keep_separate_stacks():
    both_open = threading.Barrier(2, timeout=10)
    done = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span("outer", tag=tag):
            both_open.wait()
            with spans.span("inner", tag=tag):
                done.wait()

    spans.start()
    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    records = spans.stop()
    assert len(records) == 4
    by_id = {r.span_id: r for r in records}
    for inner in (r for r in records if r.name == "inner"):
        outer = by_id[inner.parent_id]
        assert outer.name == "outer" and outer.attrs == inner.attrs
        assert inner.call_id == outer.span_id and inner.thread_id == outer.thread_id
    assert len({r.thread_id for r in records}) == 2


def test_stop_clears_what_it_returned():
    spans.start()
    with spans.span("a"):
        pass
    assert [r.name for r in spans.stop()] == ["a"]
    assert spans.stop() == []
    spans.start()
    assert spans.stop() == []


def test_a_span_open_across_stop_and_start_keeps_nothing():
    spans.start()
    s = spans.span("old")
    with s:
        spans.stop()
        spans.start()
        with spans.span("new"):
            pass
    (rec,) = spans.stop()
    assert rec.name == "new" and rec.parent_id == s.span_id
