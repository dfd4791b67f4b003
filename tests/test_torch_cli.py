"""The port's command line (``python -m quantization_tpu_torch``, ``cli.py``)
end to end on the CPU (``--device cpu``), held to the JAX package's CLI on
the same corpus and quantizer files (the pattern of ``tests/test_cli.py``).

The JAX CLI runs here only where it does not build the JAX package's native
shard loader: ``encode`` and ``decode`` read shards sequentially, and
``train`` reads an ``.hdf5`` archive.  Its compile cache is off
(``QUANTIZATION_TPU_NO_CACHE=1``).
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import quantization_tpu_torch as qtt
from quantization_tpu import cli as jcli
from quantization_tpu.data.hdf5 import write_hdf5_data
from quantization_tpu.utils import serialization as jser
from quantization_tpu_torch import cli
from quantization_tpu_torch.data.shards import iter_shards_sequential, write_shards

h5py = pytest.importorskip("h5py")

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIM = 16


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same 4,000 frames as an .hdf5 archive and as shards (3 shards
    of 1,500, so batches cross shard boundaries)."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(2000, DIM)).astype(np.float16) for _ in range(2)]
    write_hdf5_data(str(d / "corpus.hdf5"), arrays)
    write_shards(d / "shards", arrays, frames_per_shard=1500)
    return d


@pytest.fixture(scope="module")
def trained(corpus):
    """A quantizer that the port's CLI trained on the CPU from shards
    (through the port's native loader)."""
    q = corpus / "port_q.npz"
    cli.main(["train", "--data", str(corpus / "shards"), "--dim", str(DIM),
              "--bytes-per-frame", "1", "--out", str(q), "--iters", "10", "--batch", "64",
              "--chunk", "7", "--quiet", "--device", "cpu"])
    return q


def _sequential_frames(shards, n):
    return np.concatenate(list(iter_shards_sequential(shards, 4096)))[:n]


def test_convert_train_encode_decode_end_to_end(corpus, tmp_path):
    shards = tmp_path / "converted"
    assert cli.main(["convert", "--hdf5", str(corpus / "corpus.hdf5"), "--out", str(shards),
                     "--frames-per-shard", "1500"]) == 0
    # convert writes what the JAX package's writer wrote from the same frames
    for name in ["manifest.json", "shard_00000.raw", "shard_00001.raw", "shard_00002.raw"]:
        assert (shards / name).read_bytes() == (corpus / "shards" / name).read_bytes()
    q = tmp_path / "q.npz"
    cli.main(["train", "--data", str(shards), "--dim", str(DIM), "--bytes-per-frame", "1",
              "--out", str(q), "--iters", "10", "--batch", "64", "--chunk", "7", "--quiet",
              "--device", "cpu"])
    codes = tmp_path / "codes.npy"
    cli.main(["encode", "--quantizer", str(q), "--data", str(shards), "--out", str(codes),
              "--limit", "1700", "--refine-iters", "2", "--batch", "128", "--device", "cpu"])
    c = np.load(codes)
    assert c.shape == (1700, 1) and c.dtype == np.uint8
    recon = tmp_path / "recon.npy"
    cli.main(["decode", "--quantizer", str(q), "--codes", str(codes), "--out", str(recon),
              "--batch", "500", "--device", "cpu"])
    r = np.load(recon)
    assert r.shape == (1700, DIM) and r.dtype == np.float32
    # row k encodes corpus frame k, across the shard boundary at 1,500
    tq = qtt.load_quantizer(q, device="cpu")
    frames = _sequential_frames(shards, 1700)
    want = np.concatenate([tq.encode(torch.from_numpy(frames[s:s + 128]),
                                     refine_indexes_iters=2).numpy()
                           for s in range(0, 1700, 128)])
    np.testing.assert_array_equal(c, want)
    np.testing.assert_array_equal(r, tq.decode(torch.from_numpy(c)).numpy())


def test_codes_and_recon_agree_with_the_jax_cli(corpus, trained, tmp_path, monkeypatch):
    monkeypatch.setenv("QUANTIZATION_TPU_NO_CACHE", "1")
    shards = corpus / "shards"
    args = ["--quantizer", str(trained), "--data", str(shards), "--limit", "2000",
            "--batch", "256"]
    cli.main(["encode", *args, "--out", str(tmp_path / "t.npy"), "--device", "cpu"])
    jcli.main(["encode", *args, "--out", str(tmp_path / "j.npy")])
    tc, jc = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert tc.shape == jc.shape == (2000, 1) and tc.dtype == jc.dtype == np.uint8
    assert (tc == jc).all(axis=1).mean() >= 0.99  # the bar of test_torch_quantizer.py
    # both CLIs decode the port's codes
    dec = ["--quantizer", str(trained), "--codes", str(tmp_path / "t.npy")]
    cli.main(["decode", *dec, "--out", str(tmp_path / "tr.npy"), "--device", "cpu"])
    jcli.main(["decode", *dec, "--out", str(tmp_path / "jr.npy")])
    np.testing.assert_allclose(np.load(tmp_path / "tr.npy"), np.load(tmp_path / "jr.npy"),
                               rtol=1e-5, atol=1e-6)


def test_port_trained_file_loads_in_jax(trained):
    jq = jser.load_quantizer(trained)
    tq = qtt.load_quantizer(trained, device="cpu")
    assert (jq.config.dim, jq.config.codebook_size, jq.config.num_codebooks) == (DIM, 256, 1)
    assert jq.get_id() == tq.get_id()
    np.testing.assert_array_equal(np.asarray(jq.params.centers), tq.centers.detach().numpy())


def test_jax_hdf5_trained_file_loads_in_port(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("QUANTIZATION_TPU_NO_CACHE", "1")
    q = tmp_path / "jax_q.npz"
    # an .hdf5 corpus: the JAX CLI trains from memory, not its native loader
    jcli.main(["train", "--data", str(corpus / "corpus.hdf5"), "--dim", str(DIM),
               "--bytes-per-frame", "1", "--out", str(q), "--iters", "3", "--batch", "64",
               "--chunk", "7", "--quiet"])
    tq = qtt.load_quantizer(q, device="cpu")
    jq = jser.load_quantizer(q)
    assert tq.get_id() == jq.get_id() and (tq.dim, tq.num_codebooks) == (DIM, 1)
    np.testing.assert_array_equal(tq.centers.detach().numpy(), np.asarray(jq.params.centers))
    # and the port's CLI trains from the same archive
    cli.main(["train", "--data", str(corpus / "corpus.hdf5"), "--dim", str(DIM),
              "--bytes-per-frame", "1", "--out", str(tmp_path / "t.npz"), "--iters", "3",
              "--batch", "64", "--chunk", "7", "--quiet", "--device", "cpu"])
    assert qtt.load_quantizer(tmp_path / "t.npz", device="cpu").codebook_size == 256


def test_train_with_kmeans_init(corpus, tmp_path):
    """``train --init multi_kmeans`` (tests/test_cli.py:70-77): the first
    batch fits the phase-1 codebooks; the quantizer loads in both packages."""
    q = tmp_path / "qk.npz"
    cli.main(["train", "--data", str(corpus / "shards"), "--dim", str(DIM),
              "--bytes-per-frame", "1", "--out", str(q), "--iters", "5", "--batch", "64",
              "--init", "multi_kmeans", "--quiet", "--device", "cpu"])
    tq = qtt.load_quantizer(q, device="cpu")
    jq = jser.load_quantizer(q)
    assert (tq.num_codebooks, tq.codebook_size) == (1, 256)
    assert tq.get_id() == jq.get_id()
    np.testing.assert_array_equal(tq.centers.detach().numpy(), np.asarray(jq.params.centers))
    x = torch.from_numpy(_sequential_frames(corpus / "shards", 64).astype(np.float32))
    assert all(bool(torch.isfinite(v)) for v in tq.compute_loss(x))


def test_scheduling_knobs_are_accepted_and_change_nothing(corpus, trained, tmp_path):
    base = ["encode", "--quantizer", str(trained), "--data", str(corpus / "shards"),
            "--limit", "300", "--device", "cpu"]
    cli.main([*base, "--out", str(tmp_path / "a.npy")])
    cli.main([*base, "--out", str(tmp_path / "b.npy"), "--block-b", "512", "--interleave", "2"])
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))


def test_without_device_it_exits_nonzero_when_cuda_is_missing(corpus, trained, tmp_path,
                                                              monkeypatch):
    args = ["decode", "--quantizer", str(trained), "--codes", str(tmp_path / "c.npy"),
            "--out", str(tmp_path / "r.npy")]
    np.save(tmp_path / "c.npy", np.zeros((4, 1), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    assert "device='cpu'" in str(e.value.code)
    assert not (tmp_path / "r.npy").exists()
    # the module entry point, in a process of its own
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    run = subprocess.run([sys.executable, "-m", "quantization_tpu_torch", *args], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "device='cpu'" in run.stderr
    run = subprocess.run([sys.executable, "-m", "quantization_tpu_torch", *args,
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    assert np.load(tmp_path / "r.npy").shape == (4, DIM)


def test_prefetch_worker_ends_when_the_consumer_stops_early():
    def prefetch_threads():
        return [t for t in threading.enumerate() if t.name == cli.PREFETCH_THREAD]

    before = set(prefetch_threads())
    closed = []

    def source():
        try:
            yield from range(1000)
        finally:
            closed.append(True)

    gen = cli._prefetch(source(), depth=2)
    assert next(gen) == 0
    time.sleep(0.1)  # the worker fills the queue and waits in put
    workers = [t for t in prefetch_threads() if t not in before]
    assert len(workers) == 1
    gen.close()  # the consumer stops early
    workers[0].join(timeout=1.0)
    assert not workers[0].is_alive()
    assert closed == [True]  # the worker closed its source


def test_prefetch_forwards_the_workers_exception():
    def source():
        yield 1
        raise OSError("disk gone")

    gen = cli._prefetch(source())
    assert next(gen) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(gen)
