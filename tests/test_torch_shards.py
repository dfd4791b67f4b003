"""The port's shard format and loader (``quantization_tpu_torch/data/shards.py``,
``csrc/qtz_loader.cc``) held to the JAX package's ``data/shards.py``.

Writers and sequential readers must give identical bytes and batches; the
NumPy stream the same batches bit for bit for the same seed.  The native
stream's order depends on its reader threads, so it is held to the contract
of ``tests/test_shards.py``: every frame exactly once an epoch, shards
mixed, an oversized batch refused.  The JAX ``ShardStream`` is built here
only with ``force_python=True``, so these tests never build the JAX
package's native loader.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from quantization_tpu.data import shards as jsh
from quantization_tpu_torch.data import shards as tsh
from quantization_tpu_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIM = 32


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_shards")
    rng = np.random.default_rng(0)
    # frame i of array k has mean about 10 k: each frame names its source
    arrays = [rng.normal(size=(1000, DIM)).astype(np.float16) + 10 * i for i in range(5)]
    manifest = tsh.write_shards(d, arrays, frames_per_shard=1200)
    return d, manifest, arrays


def _ragged_arrays(dtype):
    rng = np.random.default_rng(1)
    return [rng.normal(size=(n, 3, 8)).astype(dtype) for n in (100, 250, 40)]  # 1,170 frames


@pytest.mark.parametrize("frames_per_shard", [200, 1170, 5000])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_write_shards_byte_identical(tmp_path, frames_per_shard, dtype):
    arrays = _ragged_arrays(dtype)
    jm = jsh.write_shards(tmp_path / "j", arrays, frames_per_shard)
    tm = tsh.write_shards(tmp_path / "t", arrays, frames_per_shard)
    assert tm == jm
    assert sum(s["frames"] for s in tm["shards"]) == 1170
    for name in ["manifest.json"] + [s["file"] for s in jm["shards"]]:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("batch", [1, 64, 1170, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_rebatch_identical(batch, dtype):
    arrays = _ragged_arrays(np.float16)
    want = list(jsh.rebatch(arrays, batch, dtype))
    got = list(tsh.rebatch(arrays, batch, dtype))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("host_index,num_hosts", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_iter_shards_sequential_identical(corpus, host_index, num_hosts, dtype):
    d, _, arrays = corpus
    kw = dict(host_index=host_index, num_hosts=num_hosts, dtype=dtype)
    want = list(jsh.iter_shards_sequential(d, 300, **kw))
    got = list(tsh.iter_shards_sequential(d, 300, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_array_equal(g, w)
    if num_hosts == 1:  # the corpus in order, frame k at row k
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(arrays).astype(dtype))


@pytest.mark.parametrize("repeat", [True, False])
def test_python_stream_matches_jax_bit_for_bit(corpus, repeat):
    d, _, _ = corpus
    kw = dict(batch_size=256, seed=1, pool_frames=2048, repeat=repeat, force_python=True)
    js, ts = jsh.ShardStream(d, **kw), tsh.ShardStream(d, **kw)
    assert not ts.native and ts.native_error is None
    n = 40 if repeat else None  # 40 batches: two epochs of 5,000 frames
    want = [b for _, b in zip(range(n or 10**6), js)]
    got = [b for _, b in zip(range(n or 10**6), ts)]
    assert len(got) == len(want) == (40 if repeat else 20)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_native_stream_non_repeat_yields_every_frame_once(corpus):
    d, _, _ = corpus
    stream = tsh.ShardStream(d, batch_size=512, seed=3, pool_frames=1024, repeat=False)
    assert stream.native, stream.native_error
    batches = list(stream)
    stream.close()
    assert sum(b.shape[0] for b in batches) == 5000
    assert all(b.shape == (512, DIM) and b.dtype == np.float32 for b in batches[:-1])
    # the corpus makes every frame unique
    assert np.unique(np.concatenate(batches), axis=0).shape[0] == 5000


def test_native_stream_repeat_mixes_shards(corpus):
    d, _, _ = corpus
    stream = tsh.ShardStream(d, batch_size=256, seed=1, pool_frames=2048, repeat=True)
    assert stream.native, stream.native_error
    seen = [b for _, b in zip(range(30), stream)]
    stream.close()
    assert all(b.shape == (256, DIM) for b in seen)
    sources = np.round(np.concatenate(seen).mean(axis=1) / 10).astype(int)
    assert set(np.unique(sources)) <= {0, 1, 2, 3, 4}
    assert len(np.unique(sources)) >= 3


@pytest.mark.parametrize("pool_frames", [5000, 8192])
def test_native_stream_first_batch_waits_for_a_full_pool(corpus, pool_frames):
    # the pool holds the whole corpus (full at 5,000, reading done at
    # 8,192): the first batch is drawn from all 5 sources, whichever reader
    # pushed first
    d, _, _ = corpus
    stream = tsh.ShardStream(d, batch_size=256, seed=1, pool_frames=pool_frames, repeat=False)
    assert stream.native, stream.native_error
    first = next(iter(stream))
    stream.close()
    sources = np.round(first.mean(axis=1) / 10).astype(int)
    assert set(np.unique(sources)) == {0, 1, 2, 3, 4}


def test_native_stream_reads_only_its_hosts_shards(corpus):
    d, manifest, _ = corpus
    want = np.concatenate(list(tsh.iter_shards_sequential(d, 4096, host_index=1, num_hosts=2)))
    stream = tsh.ShardStream(d, batch_size=100, host_index=1, num_hosts=2, pool_frames=1024,
                             repeat=False)
    assert stream.native, stream.native_error
    got = np.concatenate(list(stream))
    stream.close()
    assert got.shape == want.shape
    order = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    np.testing.assert_array_equal(order(got), order(want))


@pytest.mark.parametrize("force_python", [False, True])
def test_batch_larger_than_the_pool_is_refused(corpus, force_python):
    d, _, _ = corpus
    with pytest.raises(ValueError, match="pool_frames"):
        jsh.ShardStream(d, batch_size=2048, pool_frames=1024, force_python=True)
    with pytest.raises(ValueError, match="pool_frames"):
        tsh.ShardStream(d, batch_size=2048, pool_frames=1024, force_python=force_python)


def test_failed_build_is_recorded_and_logged(corpus, tmp_path, monkeypatch, caplog):
    d, _, _ = corpus
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "GXX_FLAGS", cuda_build.GXX_FLAGS + ["-fno-such-flag"])
    stream = tsh.ShardStream(d, batch_size=256, pool_frames=2048)
    assert not stream.native
    assert "g++ failed on csrc/qtz_loader.cc" in stream.native_error
    assert "no-such-flag" in stream.native_error  # the compiler's own message
    assert "native shard loader unavailable" in caplog.text
    assert next(iter(stream)).shape == (256, DIM)  # the NumPy stream runs


_BUILD = """
import os, pathlib, sys, time
from quantization_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = pathlib.Path(sys.argv[1])
go = pathlib.Path(sys.argv[2])
(go.parent / f"ready.{os.getpid()}").touch()
while not go.exists():
    time.sleep(0.005)
lib = cuda_build.library("qtz_loader")
print("loaded", bool(lib.qtz_loader_next))
"""


def test_two_processes_building_the_loader_both_load_it(tmp_path):
    build, sync = tmp_path / "build", tmp_path / "sync"
    sync.mkdir()
    go = sync / "go"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(go)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        deadline = time.time() + 60
        while len(list(sync.glob("ready.*"))) < 2 and time.time() < deadline:
            time.sleep(0.01)
        go.touch()  # both start compiling into the empty directory at once
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded True"
    assert sorted(f.suffix for f in build.iterdir()) == [".log", ".so"]  # no temporary left


def test_a_library_appears_only_whole(tmp_path, monkeypatch):
    # a compiler that writes part of its output first and takes its time:
    # while it runs, only this process's temporary file exists
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_libs", {})
    real = cuda_build._command
    monkeypatch.setattr(cuda_build, "_command", lambda src, out: [
        "sh", "-c", 'printf partial > "$0"; sleep 1; exec "$@"', str(out), *real(src, out)])
    so = cuda_build._target("qtz_loader")
    loaded = []
    worker = threading.Thread(target=lambda: loaded.append(cuda_build.library("qtz_loader")))
    worker.start()
    time.sleep(0.5)
    partial = [f for f in tmp_path.iterdir() if f.suffix == ".tmp"]
    assert not so.exists() and len(partial) == 1 and partial[0].read_bytes() == b"partial"
    worker.join(timeout=120)
    assert not worker.is_alive() and loaded and so.exists()
    assert not any(f.suffix == ".tmp" for f in tmp_path.iterdir())
